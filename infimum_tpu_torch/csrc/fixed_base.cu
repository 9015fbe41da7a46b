// Fixed-base windowed multiply [s_i] G of many scalars by one generator,
// G1 and G2, to affine points: the workload of Groth16 setup and zkey
// generation, every key element a known scalar times a generator.
//
// Replaces infimum_tpu/msm/fixed_base.py _kernel (a jax.jit program, :59,
// not Pallas): there XLA gathers one table point per 8-bit window of each
// scalar, masks the zero digits to infinity and folds the 32 windows with
// a scan of complete adds, over chunks of scalars; the host then takes the
// projective points to affine with one batched inversion (:115).
//
// What it computes: the table holds tab[w][d] = d * 2^(8w) * G as affine
// Montgomery points, 32 windows x 256 digits (the digit-0 slot of each
// window holds a dummy generator and is never read). One thread a scalar
// walks its 32 windows in ascending order, digit w = bits 8w..8w+7 of the
// standard-form scalar (below r), starting from infinity, and mixed-adds
// (RCB Alg. 8, field.cuh rcb_add_mixed) the window's point where the digit
// is not 0: the plain version's order (msm/fixed_base.py `_mul_chunk`).
// Then the epilogue takes each point (X : Y : Z) to affine standard-form
// words x = X/Z, y = Y/Z, below q, with (0, 0) for infinity (scalar 0):
// (0, 0) is on neither curve. Affine coordinates are unique, so the words
// equal the plain version's bit for bit whatever the order of the work.
//
// The epilogue shares one Fq inversion among a block's kFixedBlock points
// (Montgomery's trick as a product tree in shared memory): d = Z (G1) or
// the norm Z.c0^2 + Z.c1^2 (G2; Z^-1 = conj(Z) / d), 1 in a lane at
// infinity or past the end; the tree's levels multiply pairs up to the
// root (kFixedBlock - 1 products), one thread inverts the root (Kaliski's
// almost inverse, `inv_r_over`), and the levels back down give each leaf
// its inverse (two products a node). The inverses come out as
// standard-form integers 1/d, so the coordinates' Montgomery products by
// them leave Montgomery form at once: 2 Fq products a G1 point after the
// tree's 3, 2 + 2 + 2 x 3 a G2 point. The blocks of a wave reach the
// epilogue together, so the root's serial inversion idles the card: a
// Fermat power there costs the G1 kernel 1.27 ms, a binary Euclid that
// divides its coefficients by 2^k mod p 0.17 ms more than the
// division-free almost inverse (PERF.md, section 6).
//
// Design: the table (512 KB for G1, 1 MB for G2) is read with 16-byte
// loads and stays in the 50 MB L2; each thread loads its scalar's 32 bytes
// once and takes each digit from the low byte of its 256-bit value, which
// it then shifts right by 8 (funnel shifts in registers, no indexed local
// array). No chunks: one launch covers every scalar of a call. The
// products are out of line, as in msm_accum.cu, and of two carry chains
// (field.cuh `two_chains::mul`): FqTwoChains for G1 and the epilogue,
// Fq2TwoChains for G2 (inlined, an Fq2 mixed add spills). Against the one
// chain of Fp::mul the kernel takes 35% (G1) and 48% (G2) less time, in
// turns in one run of bench/fixed_base_variants.py (PERF.md, section 6).
// Measured and not kept (bench/fixed_base_variants.py): the next row
// prefetched before each add, other launch-bounds minima, blocks of 64 or
// 256 points.
//
// What bounds it, on an H100: the Montgomery products' multiplies, 11 Fq
// products a G1 mixed add and 39 a G2 one, one add a nonzero digit (up to
// 32 a scalar), and the epilogue's 5 (G1) or 13 (G2) a point. The bytes
// (32 a scalar in, 64 or 128 out) are far below.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int kC = 8;          // bits a window: = msm/fixed_base.py C
constexpr int kWindows = 32;   // windows a scalar: = N_WINDOWS
constexpr int kFixedBlock = 128;  // points sharing an inversion: = GROUP

namespace fixed {

__device__ __forceinline__ bool is_zero(const Fq::E& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0;
}

// a >> k, 1 <= k <= 31
__device__ __forceinline__ void shr(Fq::E& a, int k) {
#pragma unroll
  for (int i = 0; i < 7; ++i) a.w[i] = __funnelshift_r(a.w[i], a.w[i + 1], k);
  a.w[7] >>= k;
}

// a << k, 1 <= k <= 31
__device__ __forceinline__ void shl(Fq::E& a, int k) {
#pragma unroll
  for (int i = 7; i > 0; --i) a.w[i] = __funnelshift_l(a.w[i - 1], a.w[i], k);
  a.w[0] <<= k;
}

// r = a - b over 256 bits; the borrow out (0 or 0xffffffff)
__device__ __forceinline__ uint32_t sub_words(Fq::E& r, const Fq::E& a,
                                              const Fq::E& b) {
  r.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) r.w[j] = ptx::subc_cc(a.w[j], b.w[j]);
  return ptx::subc(0, 0);
}

// r = a + b over 256 bits, no carry out
__device__ __forceinline__ void add_words(Fq::E& r, const Fq::E& a,
                                          const Fq::E& b) {
  r.w[0] = two_chains::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 7; ++j) r.w[j] = ptx::addc_cc(a.w[j], b.w[j]);
  r.w[7] = ptx::addc(a.w[7], b.w[7]);
}

// a >>= j, x <<= j, k += j until a is odd (a = 0, only a fault, is left)
__device__ __forceinline__ void halve(Fq::E& a, Fq::E& x, int& k) {
  while (!(a.w[0] & 1u) && !is_zero(a)) {
    const int j = a.w[0] ? __ffs(a.w[0]) - 1 : 31;
    shr(a, j);
    shl(x, j);
    k += j;
  }
}

// R / a mod p for 0 < a < p, as a standard-form integer: Kaliski's almost
// Montgomery inverse (variable time: the inputs are products of public
// curve points' coordinates), several halvings a step. u = p, v = a, r =
// 0, s = 1 keep p = u s + v r, so r and s stay below p and no step reduces
// mod p; each pass subtracts the smaller odd one of u, v from the larger
// and halves the difference to odd. At u = v = 1, s = a^-1 2^k with
// 253 <= k <= 506, and one Montgomery product by 2^(512 - k) mod p leaves
// R / a: for a Montgomery word a of the value a / R, 1 / (a / R) as a
// plain integer. Each pass strips at least one of u's and v's 2 x 254
// bits, so more than 1,024 passes (or a = 0) can only be a fault: it
// returns a wrong value then, not a hang.
__device__ __noinline__ Fq::E inv_r_over(Fq::E a) {
  if (is_zero(a)) return Fq::zero();
  Fq::E u, v = a, r = Fq::zero(), s = Fq::zero();
  s.w[0] = 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) u.w[i] = FqParams::p(i);
  int k = 0;
  halve(v, r, k);
#pragma unroll 1
  for (int pass = 0; pass < 1024; ++pass) {
    Fq::E d;
    if (!sub_words(d, u, v)) {
      if (is_zero(d)) break;     // u = v = 1
      u = d;
      add_words(r, r, s);
      halve(u, s, k);
    } else {
      sub_words(v, v, u);
      add_words(s, s, r);
      halve(v, r, k);
    }
  }
  const int e = 512 - k;         // 2^e mod p, e in [6, 259]
  Fq::E t;
  if (e >= 256) {
    t = Fq::one();
#pragma unroll 1
    for (int q = 256; q < e; ++q) t = Fq::add(t, t);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) t.w[i] = i == (e >> 5) ? 1u << (e & 31) : 0u;
  }
  return FqTwoChains::mul(s, t);
}

// the Fq element whose inverse the block shares: Z, or Z's norm for G2
__device__ __forceinline__ Fq::E shared_value(const Fq::E& z) { return z; }
__device__ __forceinline__ Fq::E shared_value(const Fq2::E& z) {
  return Fq::add(FqTwoChains::mul(z.c0, z.c0), FqTwoChains::mul(z.c1, z.c1));
}

// Z^-1 from the leaf's 1 / d: itself (G1), conj(Z) / d (G2), in the form
// that leaves a product with a Montgomery word in standard form
__device__ __forceinline__ Fq::E z_inverse(const Fq::E&, const Fq::E& k) {
  return k;
}
__device__ __forceinline__ Fq2::E z_inverse(const Fq2::E& z, const Fq::E& k) {
  return {FqTwoChains::mul(z.c0, k), Fq::neg(FqTwoChains::mul(z.c1, k))};
}

}  // namespace fixed

// resident blocks an SM asked of ptxas: 6 G1 blocks cap the registers at
// 80 (spilling 352 B a thread), 1% faster than 4 blocks of 118 registers;
// 4 G2 blocks cap them at 128, 2% faster than 3 blocks of 168
template <class F>
constexpr int kMinBlocks = 6;
template <>
constexpr int kMinBlocks<Fq2TwoChains> = 4;

template <class F>
__global__ void __launch_bounds__(kFixedBlock, kMinBlocks<F>)
fixed_base_kernel(const uint4* __restrict__ scalars,
                  const uint4* __restrict__ table, uint32_t* __restrict__ out,
                  int n) {
  // the product tree, word-major: node k's word j at tree[j][k]; the
  // leaves at kFixedBlock + thread, the root at 1
  __shared__ uint32_t tree[8][2 * kFixedBlock];
  const int i = blockIdx.x * kFixedBlock + threadIdx.x;
  Proj<F> acc = proj_infinity<F>();
  if (i < n) {
    uint32_t s[8];
    {
      const uint4 lo = __ldg(scalars + 2 * (size_t)i);
      const uint4 hi = __ldg(scalars + 2 * (size_t)i + 1);
      s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
      s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
    }
#pragma unroll 1
    for (int w = 0; w < kWindows; ++w) {
      const int d = s[0] & ((1u << kC) - 1);
#pragma unroll
      for (int k = 0; k < 7; ++k) s[k] = __funnelshift_r(s[k], s[k + 1], kC);
      s[7] >>= kC;
      if (d != 0) {
        const Affine<F> q = load_row<F>(table, (w << kC) + d);
        acc = rcb_add_mixed<F>(acc, q.x, q.y);
      }
    }
  }

  // the epilogue: one inversion a block
  Fq::E d = fixed::shared_value(acc.z);
  const bool live = !fixed::is_zero(d);
  if (!live) d = Fq::one();   // infinity or past the end: skipped
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j) tree[j][kFixedBlock + t] = d.w[j];
  __syncthreads();
#pragma unroll 1
  for (int s = kFixedBlock / 2; s >= 1; s >>= 1) {
    if (t < s) {
      const int k = s + t;
      Fq::E a, b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a.w[j] = tree[j][2 * k];
        b.w[j] = tree[j][2 * k + 1];
      }
      const Fq::E c = FqTwoChains::mul(a, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) tree[j][k] = c.w[j];
    }
    __syncthreads();
  }
  if (t == 0) {
    Fq::E root;
#pragma unroll
    for (int j = 0; j < 8; ++j) root.w[j] = tree[j][1];
    const Fq::E inv = fixed::inv_r_over(root);
#pragma unroll
    for (int j = 0; j < 8; ++j) tree[j][1] = inv.w[j];
  }
  __syncthreads();
  // node k now holds 1 / (its product): its children's are that times the
  // sibling's product
#pragma unroll 1
  for (int s = 1; s < kFixedBlock; s <<= 1) {
    if (t < s) {
      const int k = s + t;
      Fq::E inv, a, b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        inv.w[j] = tree[j][k];
        a.w[j] = tree[j][2 * k];
        b.w[j] = tree[j][2 * k + 1];
      }
      const Fq::E ia = FqTwoChains::mul(inv, b);
      const Fq::E ib = FqTwoChains::mul(inv, a);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tree[j][2 * k] = ia.w[j];
        tree[j][2 * k + 1] = ib.w[j];
      }
    }
    __syncthreads();
  }
  if (i >= n) return;
  Fq::E k;
#pragma unroll
  for (int j = 0; j < 8; ++j) k.w[j] = tree[j][kFixedBlock + t];
  typename F::E x = F::zero(), y = F::zero();
  if (live) {
    const typename F::E zi = fixed::z_inverse(acc.z, k);
    x = F::mul(acc.x, zi);
    y = F::mul(acc.y, zi);
  }
  uint32_t* row = out + (size_t)i * 2 * F::WORDS;
  F::store(row, 1, x);
  F::store(row + F::WORDS, 1, y);
}

template <class F>
int launch_fixed_base(const void* scalars, const void* table, void* out, int n,
                      void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  fixed_base_kernel<F><<<(n + kFixedBlock - 1) / kFixedBlock, kFixedBlock, 0,
                         (cudaStream_t)stream>>>(
      (const uint4*)scalars, (const uint4*)table, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

template <class F>
int blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fixed_base_kernel<F>, kFixedBlock, 0) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace inf

// scalars: (n, 8) standard-form words below r, 16-byte aligned; table:
// (kWindows << kC, 2W) affine Montgomery words, row w * 256 + d holding
// d * 2^(8w) * G (x then y); out: (n, 2W) affine standard-form words, x
// then y (each c0 then c1 for G2), (0, 0) for infinity.
extern "C" int inf_fixed_base_g1(const void* scalars, const void* table,
                                 void* out, int n, void* stream) {
  return inf::launch_fixed_base<inf::FqTwoChains>(scalars, table, out, n,
                                                  stream);
}

extern "C" int inf_fixed_base_g2(const void* scalars, const void* table,
                                 void* out, int n, void* stream) {
  return inf::launch_fixed_base<inf::Fq2TwoChains>(scalars, table, out, n,
                                                   stream);
}

// resident blocks an SM of each instance on the current card (CUDA's
// occupancy calculator), -1 on an error
extern "C" int inf_fixed_base_blocks_per_sm_g1() {
  return inf::blocks_per_sm<inf::FqTwoChains>();
}

extern "C" int inf_fixed_base_blocks_per_sm_g2() {
  return inf::blocks_per_sm<inf::Fq2TwoChains>();
}
