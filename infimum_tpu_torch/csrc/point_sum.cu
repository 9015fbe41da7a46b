// The sharded MSM's cross-rank sum of window sums, G1 and G2.
//
// Replaces infimum_tpu/parallel/msm.py _tree_reduce_axis0 (:31, an XLA
// program inside shard_map: masked halving in a fori_loop of complete
// adds) and the permute round's curve.add (:127). In the port both ran as
// one complete add in plain torch a level, about 2,000 launches a round.
//
// What it computes: D projective points a window, (D, nwin, PW) words,
// summed to (nwin, PW). The order is the plain version's (parallel/msm.py
// `_tree_reduce_axis0`): padded with infinity (0, 1, 0) to a power of two
// T >= D, then halved, entry i plus entry i + T/2, until one is left. Each
// add is field.cuh's rcb_add (RCB Alg. 7), the formula of curve/proj.py
// `add`, and every field operation returns the reduced value, so the
// output equals the plain version's limbs bit for bit. It takes D >= 2
// (the wrapper returns D = 1's one entry as it is); the permute round is
// D = 2 (mine, then my partner's).
//
// What bounds it: latency. A sum is log2(T) levels of dependent adds over
// 20 or 26 windows, a few hundred products in all; the card's rates would
// take well under a microsecond. What the design does about it:
// - One block a window, and all of a level's adds at once, a warp an add
//   (up to kMaxWarps; a warp takes more adds of a level in turn). Between
//   levels the block synchronises; a level's points stay in shared memory,
//   or, while a level has more than kLevelPoints of them, in the global
//   scratch (T/2, nwin, PW), so any D works.
// - Each complete add is split over the lanes of its warp in RCB Alg. 7's
//   own layers: the 6 independent first-layer products, the two 3b
//   products, the 6 last-layer products, a lane a product (a G2 product
//   is split into its 3 Karatsuba Fq products: up to 18 lanes a layer).
//   The additions between the layers are split too, a lane a value and
//   Fq component, and every result goes through the warp's slots in
//   shared memory, with a __syncwarp at each step. So a level's chain is
//   2 (G1: its 3b is additions) or 3 (G2) products deep, not 12 or 42.
// - Each product is field.cuh's two-carry-chain FqTwoChains::mul (out of
//   line, by value: one copy of its code); additions and subtractions run
//   over the carry flag (fq_add, fq_sub).
// Step by step, for an add P + Q (slot names after rcb_add's values):
//   products    P0..P5 = X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2),
//               (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
//   (G2: the Karatsuba parts joined into P0..P5)
//   sums        t3 = P3 - (P0 + P1), t4 = P4 - (P1 + P2),
//               y3 = P5 - (P0 + P2), t0x3 = (P0 + P0) + P0
//   3b          B0 = 3b P2, B1 = 3b y3 (G1: additions; G2: products by
//               the constant)
//   sums        Z3 = P1 + B0, t1n = P1 - B0 (Y3b = B1)
//   products    Q0..Q5 = t4 Y3b, t3 t1n, Y3b t0x3, t1n Z3, t0x3 t3, Z3 t4
//   output      X3 = Q1 - Q0, Y3 = Q3 + Q2, Z3 = Q5 + Q4
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {
namespace sum {

constexpr int kMaxWarps = 8;      // adds of a level at once, a warp each
constexpr int kLevelPoints = 16;  // a level's points shared memory holds

// A curve's field element as K Fq components (G1: 1; G2: 2, c0 then c1),
// a point as 3 K of them (X, Y, Z), 8 words each.
template <int K>
struct Slots;

// G1: a slot a value: P0..P5, t3, t4, y3, t0x3, B0, B1 (= Y3b), Z3, t1n,
// Q0..Q5
template <>
struct Slots<1> {
  static constexpr int kP = 0, kT3 = 6, kT4 = 7, kY3 = 8, kT0x3 = 9,
                       kB = 10, kY3b = 11, kZ3 = 12, kT1n = 13, kQ = 14,
                       kCount = 20;
  static __device__ __forceinline__ int p(int j, int) { return kP + j; }
  static __device__ __forceinline__ int v(int base, int) { return base; }
};

// G2: a slot an Fq component or a Karatsuba part
template <>
struct Slots<2> {
  // parts 3 j + k of the first products, the joined P_j at kP + 2 j + c,
  // the sums' values from kT3 (2 slots each), the 3b parts kB + 3 w + k,
  // Z3, t1n, Y3b, the last products' parts kQ + 3 j + k
  static constexpr int kP = 18, kT3 = 30, kT4 = 32, kY3 = 34, kT0x3 = 36,
                       kB = 38, kZ3 = 44, kT1n = 46, kY3b = 48, kQ = 50,
                       kCount = 68;
  static __device__ __forceinline__ int p(int j, int c) {
    return kP + 2 * j + c;
  }
  static __device__ __forceinline__ int v(int base, int c) { return base + c; }
};

// the warp's value slots, 8 words each
struct Warp {
  uint32_t (*s)[8];
  __device__ __forceinline__ Fq::E get(int i) const {
    return Fq::load(s[i], 1);
  }
  __device__ __forceinline__ void put(int i, const Fq::E& a) const {
    Fq::store(s[i], 1, a);
  }
};

// component c of a point's coordinate xyz (0 X, 1 Y, 2 Z)
template <int K>
__device__ __forceinline__ Fq::E coord(const uint32_t* p, int xyz, int c) {
  return Fq::load(p + (xyz * K + c) * 8, 1);
}

// a + b and a - b mod q over the carry flag: the reduced values of
// Fq::add and Fq::sub, whose 64-bit word loops took 8-22% more time a sum
// (PERF.md, section 6). A level's chain holds 8-15 of them.
__device__ __forceinline__ Fq::E fq_add(const Fq::E& a, const Fq::E& b) {
  Fq::E s, d;  // a + b < 2q < 2^255: no carry out
  s.w[0] = two_chains::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) s.w[i] = ptx::addc_cc(a.w[i], b.w[i]);
  d.w[0] = ptx::sub_cc(s.w[0], FqParams::p(0));
#pragma unroll
  for (int i = 1; i < 8; ++i) d.w[i] = ptx::subc_cc(s.w[i], FqParams::p(i));
  const uint32_t borrow = ptx::subc(0, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) d.w[i] = borrow ? s.w[i] : d.w[i];
  return d;
}

__device__ __forceinline__ Fq::E fq_sub(const Fq::E& a, const Fq::E& b) {
  Fq::E d, r;
  d.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) d.w[i] = ptx::subc_cc(a.w[i], b.w[i]);
  const uint32_t m = ptx::subc(0, 0);  // all ones where a < b: add q
  r.w[0] = two_chains::add_cc(d.w[0], FqParams::p(0) & m);
#pragma unroll
  for (int i = 1; i < 7; ++i) r.w[i] = ptx::addc_cc(d.w[i], FqParams::p(i) & m);
  r.w[7] = ptx::addc(d.w[7], FqParams::p(7) & m);
  return r;
}

// 9x = 3b x for G1 (b = 3): Fq::b3's three doublings and an add
__device__ __forceinline__ Fq::E fq_b3(const Fq::E& x) {
  const Fq::E x2 = fq_add(x, x), x4 = fq_add(x2, x2);
  return fq_add(fq_add(x4, x4), x);
}

// component c of the Karatsuba product whose parts (v0, v1, s) are slots
// base .. base + 2: c0 = v0 - v1, c1 = (s - v0) - v1, as Fq2 mul
__device__ __forceinline__ Fq::E joined(const Warp& w, int base, int c) {
  Fq::E x = w.get(base + (c ? 2 : 0));
  if (c) x = fq_sub(x, w.get(base));
  return fq_sub(x, w.get(base + 1));
}

// an operand of the first products (lane l < 6 parts: product j = l /
// parts, part k = l % parts): a coordinate of the point p, or the sum of
// two, the component (G2: c0, c1 or c0 + c1) that part k takes
template <int K>
__device__ __forceinline__ Fq::E first_operand(const uint32_t* p, int j,
                                               int k) {
  const int ca = j < 3 ? j : (j == 4 ? 1 : 0), cb = j == 3 ? 1 : 2;
  auto part = [&](int c) {
    Fq::E x = coord<K>(p, ca, c);
    if (j >= 3) x = fq_add(x, coord<K>(p, cb, c));
    return x;
  };
  if (K == 1) return part(0);
  Fq::E x = part(k == 2 ? 0 : k);
  if (k == 2) x = fq_add(x, part(1));
  return x;
}

// One complete add, P + Q into `dst`, by the 32 lanes of a warp.
template <int K>
__device__ void warp_add(const uint32_t* p, const uint32_t* q, uint32_t* dst,
                         int lane, const Warp& w) {
  using S = Slots<K>;
  constexpr int parts = K == 1 ? 1 : 3;
  // 1. the first products
  if (lane < 6 * parts) {
    const int j = lane / parts, k = lane % parts;
    w.put(K == 1 ? S::kP + j : 3 * j + k,
          FqTwoChains::mul(first_operand<K>(p, j, k),
                           first_operand<K>(q, j, k)));
  }
  __syncwarp();
  if (K == 2) {  // the Karatsuba parts joined: P_j component c
    if (lane < 12)
      w.put(S::p(lane >> 1, lane & 1), joined(w, 3 * (lane >> 1), lane & 1));
    __syncwarp();
  }
  // 2. t3, t4, y3 = X - (Y + Z); t0x3 = (P0 + P0) + P0: value u, comp c
  if (lane < 4 * K) {
    const int u = lane / K, c = lane % K;
    // P_j indices of X, Y and Z, 4 bits a value
    constexpr uint32_t X = 3 | 4 << 4 | 5 << 8, Y = 0 | 1 << 4,
                       Z = 1 | 2 << 4 | 2 << 8;
    const Fq::E s = fq_add(w.get(S::p(Y >> 4 * u & 15, c)),
                           w.get(S::p(Z >> 4 * u & 15, c)));
    const Fq::E x = w.get(S::p(X >> 4 * u & 15, c));
    w.put(S::v(S::kT3 + K * u, c), u < 3 ? fq_sub(x, s) : fq_add(s, x));
  }
  __syncwarp();
  // 3. B0 = 3b P2, B1 = 3b y3
  if (K == 1) {
    if (lane < 2)
      w.put(S::kB + lane, fq_b3(w.get(lane ? S::kY3 : S::p(2, 0))));
  } else if (lane < 6) {  // (x0 + x1 u)(k0 + k1 u), Fq2TwoChains::b3's parts
    constexpr uint32_t K0[8] = INF_G2_B3_C0;
    constexpr uint32_t K1[8] = INF_G2_B3_C1;
    const Fq::E k0 = Fq::constant(K0), k1 = Fq::constant(K1);
    const int which = lane / 3, k = lane % 3;
    const int x = which ? S::kY3 : S::p(2, 0);
    Fq::E a = w.get(x + (k == 1)), b = k == 1 ? k1 : k0;
    if (k == 2) {
      a = fq_add(a, w.get(x + 1));
      b = fq_add(k0, k1);
    }
    w.put(S::kB + lane, FqTwoChains::mul(a, b));
  }
  __syncwarp();
  // 4. Z3 = P1 + B0, t1n = P1 - B0 (and for G2 Y3b = B1 joined): value u,
  // component c
  if (lane < (K == 1 ? 2 : 6)) {
    const int u = lane / K, c = lane % K;
    const Fq::E b = K == 1 ? w.get(S::kB)
                           : joined(w, S::kB + (u == 2 ? 3 : 0), c);
    const Fq::E t1 = w.get(S::p(1, c));
    w.put(S::v(S::kZ3 + K * u, c),
          u == 0 ? fq_add(t1, b) : u == 1 ? fq_sub(t1, b) : b);
  }
  __syncwarp();
  // 5. the last products Q_j = A_j B_j, operands' value slots packed 8
  // bits each (G1 slots; G2 the value's first component)
  if (lane < 6 * parts) {
    const int j = lane / parts, k = lane % parts;
    constexpr uint64_t A = uint64_t(S::kT4) | uint64_t(S::kT3) << 8 |
                           uint64_t(S::kY3b) << 16 | uint64_t(S::kT1n) << 24 |
                           uint64_t(S::kT0x3) << 32 | uint64_t(S::kZ3) << 40;
    constexpr uint64_t B = uint64_t(S::kY3b) | uint64_t(S::kT1n) << 8 |
                           uint64_t(S::kT0x3) << 16 | uint64_t(S::kZ3) << 24 |
                           uint64_t(S::kT3) << 32 | uint64_t(S::kT4) << 40;
    const int ia = int(A >> 8 * j & 255), ib = int(B >> 8 * j & 255);
    Fq::E a = w.get(ia + (k == 1)), b = w.get(ib + (k == 1));
    if (k == 2) {
      a = fq_add(a, w.get(ia + 1));
      b = fq_add(b, w.get(ib + 1));
    }
    w.put(K == 1 ? S::kQ + j : S::kQ + lane, FqTwoChains::mul(a, b));
  }
  __syncwarp();
  // 6. X3 = Q1 - Q0, Y3 = Q3 + Q2, Z3 = Q5 + Q4: coordinate o, comp c
  if (lane < 3 * K) {
    const int o = lane / K, c = lane % K;
    const Fq::E hi = K == 1 ? w.get(S::kQ + 2 * o + 1)
                            : joined(w, S::kQ + 3 * (2 * o + 1), c);
    const Fq::E lo = K == 1 ? w.get(S::kQ + 2 * o)
                            : joined(w, S::kQ + 3 * (2 * o), c);
    Fq::store(dst + (o * K + c) * 8, 1, o == 0 ? fq_sub(hi, lo)
                                               : fq_add(hi, lo));
  }
  __syncwarp();
}

// entry i of a (rows, nwin, PW) words array, for window w
template <int K>
__device__ __forceinline__ size_t at(int i, int w, int nwin) {
  return ((size_t)i * nwin + w) * 3 * K * 8;
}

// entry i of a level of `points` points of window w: in shared memory, or
// above kLevelPoints in the scratch
template <int K>
__device__ __forceinline__ uint32_t* entry(uint32_t* scratch,
                                           uint32_t (*level)[3 * K * 8],
                                           int i, int points, int w,
                                           int nwin) {
  return points > kLevelPoints ? scratch + at<K>(i, w, nwin) : level[i];
}

template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
point_sum_kernel(const uint32_t* __restrict__ in, uint32_t* scratch,
                 uint32_t* __restrict__ out, int D, int nwin) {
  constexpr int PW = 3 * K * 8;
  __shared__ uint32_t slots[kMaxWarps][Slots<K>::kCount][8];
  __shared__ uint32_t level[kLevelPoints][PW];
  __shared__ uint32_t infinity[PW];
  const int win = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const Warp w{slots[warp]};
  for (int k = threadIdx.x; k < PW; k += blockDim.x)  // (0, 1, 0)
    infinity[k] = k >= K * 8 && k < K * 8 + 8 ? FqParams::one(k - K * 8) : 0;
  __syncthreads();
  int half = 1;
  while (2 * half < D) half *= 2;  // T = 2 half >= D > half
  // the level of h adds writes entry i < h, the last to the output; the
  // first reads the input, entry i < half < D real, i + half maybe padding
  for (int i = warp; i < half; i += warps)
    warp_add<K>(in + at<K>(i, win, nwin),
                i + half < D ? in + at<K>(i + half, win, nwin) : infinity,
                half == 1 ? out + (size_t)win * PW
                          : entry<K>(scratch, level, i, half, win, nwin),
                lane, w);
  __syncthreads();
  for (int h = half / 2; h >= 1; h /= 2) {
    for (int i = warp; i < h; i += warps)  // entry i read, then written
      warp_add<K>(entry<K>(scratch, level, i, 2 * h, win, nwin),
                  entry<K>(scratch, level, i + h, 2 * h, win, nwin),
                  h == 1 ? out + (size_t)win * PW
                         : entry<K>(scratch, level, i, h, win, nwin),
                  lane, w);
    __syncthreads();
  }
}

template <int K>
int launch(const void* in, void* scratch, void* out, int D, int nwin,
           void* stream) {
  if (D < 2 || nwin < 1) return (int)cudaErrorInvalidValue;
  int half = 1;
  while (2 * half < D) half *= 2;
  if (half > kLevelPoints && !scratch) return (int)cudaErrorInvalidValue;
  const int warps = half < kMaxWarps ? half : kMaxWarps;
  point_sum_kernel<K><<<nwin, warps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)scratch, (uint32_t*)out, D, nwin);
  return (int)cudaGetLastError();
}

}  // namespace sum
}  // namespace inf

// in: (D, nwin, 3W) projective words, D >= 2; scratch: (T/2, nwin, 3W)
// words for T the power of two >= D, read and written only while a level
// has more than kLevelPoints points (T > 32; may be null below); out:
// (nwin, 3W) words.
extern "C" int inf_point_sum_g1(const void* in, void* scratch, void* out,
                                int D, int nwin, void* stream) {
  return inf::sum::launch<1>(in, scratch, out, D, nwin, stream);
}

extern "C" int inf_point_sum_g2(const void* in, void* scratch, void* out,
                                int D, int nwin, void* stream) {
  return inf::sum::launch<2>(in, scratch, out, D, nwin, stream);
}
