// Weighted bucket reduction for the signed-digit Pippenger MSM.
//
// Replaces infimum_tpu/msm/pallas_msm.py _make_weighted_kernel, launched by
// _weighted_call (grid over windows and 1024-entry chunks, a c-bit
// double-and-add per entry, tree reduction with 0/1 partner-shift matrices
// on the MXU). None of that carries over.
//
// What it computes: for each window, sum over its compacted emissions e of
// d_e * P_e, which equals sum_d d * B_d (the weights are the bucket
// indices). Compaction (msm.py `compact`) lists each window's live entries
// first and in non-decreasing digit order, then zero padding (digit 0).
//
// Design, two launches:
//  1. `msm_weighted_chunks`: one thread per chunk of CHUNK consecutive
//     slots, 32 chunks (one warp) per block, a grid of (blocks per window,
//     windows). A thread walks its chunk's live entries from the top digit
//     down with a running sum: S += P_e at every entry, A += (d_above - d_e)
//     * S at every step, and A += d_first * S below the last entry, so
//     A = sum d_e P_e with one add per entry, one per change of digit and a
//     multiple of S by the chunk's smallest digit (2-bit windows). The warp
//     then sums its 32 chunk values with shuffles, and lane 0 writes the
//     block's partial.
//  2. `msm_weighted_combine`: one warp per window sums its blocks' partials.
// Any order of adds gives the same window point; only the affine point is
// used. A block whose first slot is padding holds no live entry and writes
// infinity at once.
//
// What should bound it (not measured apart): the latency of a thread's
// chain of dependent complete adds at a few warps an SM, then the multiply
// pipe once the warps are many. A warp runs its lanes' gaps and multiples
// in lockstep. The chunk size trades threads (more warps an SM) against
// the per-chunk multiple by the smallest digit; it is fixed per curve
// (CHUNK_G1, CHUNK_G2, equal to msm.py `CurveSpec.chunk`) and gives at
// least 132 blocks at the main path's shapes.
// The complete add stays one out-of-line function: inlined at its call
// sites, the G2 instance made nvcc crash (segmentation fault) on sm_90a.
// G2 runs over field.cuh's Fq2OutOfLine, the Fq2 product out of line.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int WARP = 32;
constexpr int CHUNK_G1 = 8;  // slots a thread walks
constexpr int CHUNK_G2 = 4;

template <class F>
__device__ __noinline__ Proj<F> add(const Proj<F>& p, const Proj<F>& q) {
  return rcb_add<F>(p, q);
}

// a + g * s for g >= 0, by double-and-add from g's top bit: the gaps of the
// walk, mostly 1
template <class F>
__device__ Proj<F> add_multiple(const Proj<F>& a, const Proj<F>& s, int g) {
  if (g == 0) return a;
  Proj<F> t = s;
  for (int b = 30 - __clz(g); b >= 0; --b) {
    t = add<F>(t, t);
    if ((g >> b) & 1) t = add<F>(t, s);
  }
  return add<F>(a, t);
}

template <class F>
__device__ __forceinline__ Proj<F> pick(int k, const Proj<F>& s1,
                                        const Proj<F>& s2, const Proj<F>& s3) {
  return k == 1 ? s1 : (k == 2 ? s2 : s3);
}

// a + g * s for g > 0 in 2-bit windows from the top, with s, 2s and 3s: the
// chunk's smallest digit, 10-13 bits. A warp runs its lanes' windows in
// lockstep, so this costs 2 + 3 adds a window where binary costs up to 4.
template <class F>
__device__ Proj<F> add_multiple_w2(const Proj<F>& a, const Proj<F>& s, int g) {
  const Proj<F> s2 = add<F>(s, s);
  const Proj<F> s3 = add<F>(s2, s);
  int i = (31 - __clz(g)) >> 1;
  Proj<F> t = pick<F>((g >> 2 * i) & 3, s, s2, s3);
  for (--i; i >= 0; --i) {
    t = add<F>(t, t);
    t = add<F>(t, t);
    const int k = (g >> 2 * i) & 3;
    if (k) t = add<F>(t, pick<F>(k, s, s2, s3));
  }
  return add<F>(a, t);
}

template <class F>
__device__ __forceinline__ Proj<F> shfl_down(const Proj<F>& p, int off) {
  Proj<F> r;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&p);
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 3 * F::WORDS; ++i)
    d[i] = __shfl_down_sync(0xffffffffu, s[i], off);
  return r;
}

// sum over the warp's lanes, in lane 0; every lane must take part
template <class F>
__device__ Proj<F> warp_sum(Proj<F> v) {
  for (int off = WARP / 2; off > 0; off >>= 1)
    v = add<F>(v, shfl_down<F>(v, off));
  return v;
}

template <class F, int CHUNK>
__global__ void __launch_bounds__(WARP)
msm_weighted_chunks(const int32_t* __restrict__ cdig,
                    const uint32_t* __restrict__ cpts,
                    uint32_t* __restrict__ partial, int K) {
  constexpr int PW = 3 * F::WORDS;
  const int win = blockIdx.y, lane = threadIdx.x;
  const int32_t* dig = cdig + (size_t)win * K;
  const uint32_t* pts = cpts + (size_t)win * PW * K;
  uint32_t* part = partial + ((size_t)win * gridDim.x + blockIdx.x) * PW;
  const int first = blockIdx.x * WARP * CHUNK;
  if (dig[first] == 0) {  // warp-uniform: the live entries lie below
    if (lane == 0) store_proj<F>(part, 1, proj_infinity<F>());
    return;
  }

  Proj<F> acc = proj_infinity<F>();
  const int lo = first + lane * CHUNK;
  const int hi = min(lo + CHUNK, K);
  if (lo < hi && dig[lo] != 0) {
    int top = lo;
    while (top + 1 < hi && dig[top + 1] != 0) ++top;
    Proj<F> s = load_proj<F>(pts + top, K);
    int above = dig[top];
    for (int k = top - 1; k >= lo; --k) {
      const int d = dig[k];
      acc = add_multiple<F>(acc, s, above - d);
      s = add<F>(s, load_proj<F>(pts + k, K));
      above = d;
    }
    acc = add_multiple_w2<F>(acc, s, above);
  }
  acc = warp_sum<F>(acc);
  if (lane == 0) store_proj<F>(part, 1, acc);
}

template <class F>
__global__ void __launch_bounds__(WARP)
msm_weighted_combine(const uint32_t* __restrict__ partial,
                     uint32_t* __restrict__ out, int nblk) {
  constexpr int PW = 3 * F::WORDS;
  const uint32_t* part = partial + (size_t)blockIdx.x * nblk * PW;
  Proj<F> acc = threadIdx.x < nblk ? load_proj<F>(part + threadIdx.x * PW, 1)
                                   : proj_infinity<F>();
  for (int b = threadIdx.x + WARP; b < nblk; b += WARP)
    acc = add<F>(acc, load_proj<F>(part + (size_t)b * PW, 1));
  acc = warp_sum<F>(acc);
  if (threadIdx.x == 0) store_proj<F>(out + (size_t)blockIdx.x * PW, 1, acc);
}

template <class F, int CHUNK>
int launch_weighted(const void* cdig, const void* cpts, void* partial,
                    void* out, int nwin, int K, void* stream) {
  const int nblk = (K + WARP * CHUNK - 1) / (WARP * CHUNK);
  msm_weighted_chunks<F, CHUNK>
      <<<dim3(nblk, nwin), WARP, 0, (cudaStream_t)stream>>>(
          (const int32_t*)cdig, (const uint32_t*)cpts, (uint32_t*)partial, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_weighted_combine<F><<<nwin, WARP, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partial, (uint32_t*)out, nblk);
  return (int)cudaGetLastError();
}

}  // namespace inf

// cdig: (nwin, K) int32; cpts: (nwin, 3W, K) words; partial: scratch of
// (nwin, ceil(K / (32 * CHUNK)), 3W) words; out: (nwin, 3W) words.
extern "C" int inf_msm_weighted_g1(const void* cdig, const void* cpts,
                                   void* partial, void* out, int nwin, int K,
                                   void* stream) {
  return inf::launch_weighted<inf::Fq, inf::CHUNK_G1>(cdig, cpts, partial,
                                                      out, nwin, K, stream);
}

extern "C" int inf_msm_weighted_g2(const void* cdig, const void* cpts,
                                   void* partial, void* out, int nwin, int K,
                                   void* stream) {
  return inf::launch_weighted<inf::Fq2OutOfLine, inf::CHUNK_G2>(
      cdig, cpts, partial, out, nwin, K, stream);
}
