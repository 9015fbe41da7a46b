// Radix-2 NTT over BN254 Fr (a tile launch and one launch a remaining
// stage) and the elementwise Fr step of the H pipeline, for batches of
// transforms.
//
// Replaces the XLA programs the JAX package compiles for its H stage:
// infimum_tpu/ntt/ntt.py:121 `_ntt_core` (iterative decimation-in-time
// radix-2, bit reversal first, the packed twiddle table of `_stage_consts`
// :81), its coset forms `_coset_ntt_jit` :206 and `_coset_intt_jit` :219,
// and the pointwise steps of infimum_tpu/groth16/groth16.py:386 `_h_graph`
// (a.b - c, x 1/Z), of infimum_tpu/groth16/rowval.py:87 `_encode_witness`
// (x R^2) and the zkey's c = a.b (infimum_tpu/groth16/zkey.py:160). A value is 8
// little-endian 32-bit words in Montgomery form (R = 2^256), the same
// integer as the plain version's 16 limbs, so every output equals the
// plain version's bit for bit: each step returns a reduced value.
//
// What bounds it: device memory. A stage reads and writes every value
// once (64 B a butterfly) for one Fr product (264 32-bit multiplies): at
// 3.35 TB/s and 1.67e13 multiplies/s an H100 moves a butterfly in 19 ps
// and multiplies it in 16 ps. A transform of 2^18 values in nine passes
// (one tile launch for stages 1-10, one launch for each of stages 11-18)
// moves 9 x 2 x 8 MB a transform; a single pass would move 2 x 8 MB.
//
// Design (the first, simple one):
// - Values are element-major, (B, n, 8) words: a thread loads a value as
//   two 16-byte vectors, neighbouring threads neighbouring values.
// - The tile launch: one block for 2^10 consecutive positions of one
//   transform (all n when n <= 2^10). It gathers its bit-reversed inputs
//   into shared memory (32 KB, word-major so that neighbouring positions
//   are neighbouring banks), multiplies each by the input table at its
//   natural index (the coset powers g^i of a coset NTT), runs the stages
//   that fit in the tile with __syncthreads between them, and writes the
//   tile back; when the tile is the whole transform, the output multiplies
//   are fused in.
// - The stage launch: one thread a butterfly of one global stage, in
//   place. The last stage fuses the output multiplies: a constant (1/n,
//   and with it the exit from Montgomery form, as a constant in standard
//   form) and a table indexed by the output position (the inverse coset
//   powers).
// - The pointwise launch: one thread a value, out = (a [x b] [- c]) [x k].
// - Products: the butterfly's product inlined (Fr::mul), the optional
//   multiplies out of line (FrOutOfLine::mul), one copy each.
// - The leading dim B is the grid's y (tile) or folds into the thread
//   index (stage), so the three transforms of a prove's a, b, c run in
//   one launch a pass.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace inf {

constexpr int kTileLog = 10;  // ntt/ntt.py TILE_LOG must equal it
constexpr int kTile = 1 << kTileLog;
constexpr int kTileThreads = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ Fr::E load_value(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_value(uint32_t* p, const Fr::E& a) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

// x * post_c * post_t[i], each factor where its pointer is not null
__device__ __forceinline__ Fr::E post_multiply(Fr::E x, const uint32_t* post_c,
                                               const uint32_t* post_t,
                                               size_t i) {
  if (post_c) x = FrOutOfLine::mul(x, load_value(post_c));
  if (post_t) x = FrOutOfLine::mul(x, load_value(post_t + 8 * i));
  return x;
}

__global__ void __launch_bounds__(kTileThreads)
    fr_ntt_tile_kernel(const uint32_t* __restrict__ in,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ pre,
                       const uint32_t* __restrict__ post_c,
                       const uint32_t* __restrict__ post_t, int logn,
                       int tlog) {
  __shared__ uint32_t s[8][kTile];
  const size_t n = size_t(1) << logn;
  const int tile = 1 << tlog;
  const uint32_t* src = in + blockIdx.y * n * 8;
  uint32_t* dst = out + blockIdx.y * n * 8;
  const uint32_t base = blockIdx.x << tlog;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const uint32_t p = base + i;
    const uint32_t r = logn ? __brev(p) >> (32 - logn) : 0;
    Fr::E x = load_value(src + 8 * size_t(r));
    if (pre) x = FrOutOfLine::mul(x, load_value(pre + 8 * size_t(r)));
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w][i] = x.w[w];
  }
  __syncthreads();
  for (int st = 1; st <= tlog; ++st) {
    const int half = 1 << (st - 1);
    for (int j = threadIdx.x; j < tile / 2; j += blockDim.x) {
      const int k = j & (half - 1);
      const int lo = ((j >> (st - 1)) << st) | k;
      const int hi = lo + half;
      Fr::E u, t;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        u.w[w] = s[w][lo];
        t.w[w] = s[w][hi];
      }
      const Fr::E v = Fr::mul(t, load_value(tw + 8 * size_t(half - 1 + k)));
      const Fr::E a = Fr::add(u, v);
      const Fr::E b = Fr::sub(u, v);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s[w][lo] = a.w[w];
        s[w][hi] = b.w[w];
      }
    }
    __syncthreads();
  }
  const bool last = tlog == logn;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    Fr::E x;
#pragma unroll
    for (int w = 0; w < 8; ++w) x.w[w] = s[w][i];
    if (last) x = post_multiply(x, post_c, post_t, base + i);
    store_value(dst + 8 * size_t(base + i), x);
  }
}

__global__ void __launch_bounds__(kThreads)
    fr_ntt_stage_kernel(uint32_t* __restrict__ data,
                        const uint32_t* __restrict__ tw,
                        const uint32_t* __restrict__ post_c,
                        const uint32_t* __restrict__ post_t, int logn, int st,
                        size_t total) {
  const size_t g = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const size_t b = g >> (logn - 1);
  const size_t j = g & ((size_t(1) << (logn - 1)) - 1);
  const size_t half = size_t(1) << (st - 1);
  const size_t k = j & (half - 1);
  const size_t lo = ((j >> (st - 1)) << st) | k;
  const size_t hi = lo + half;
  uint32_t* a = data + (b << logn) * 8;
  const Fr::E u = load_value(a + 8 * lo);
  const Fr::E v =
      Fr::mul(load_value(a + 8 * hi), load_value(tw + 8 * (half - 1 + k)));
  Fr::E x = Fr::add(u, v);
  Fr::E y = Fr::sub(u, v);
  if (post_c || post_t) {
    x = post_multiply(x, post_c, post_t, lo);
    y = post_multiply(y, post_c, post_t, hi);
  }
  store_value(a + 8 * lo, x);
  store_value(a + 8 * hi, y);
}

__global__ void __launch_bounds__(kThreads)
    fr_pointwise_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        const uint32_t* __restrict__ c,
                        const uint32_t* __restrict__ k,
                        uint32_t* __restrict__ out, size_t n) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fr::E x = load_value(a + 8 * i);
  if (b) x = Fr::mul(x, load_value(b + 8 * i));
  if (c) x = Fr::sub(x, load_value(c + 8 * i));
  if (k) x = Fr::mul(x, load_value(k));
  store_value(out + 8 * i, x);
}

}  // namespace inf

// The first pass of B transforms of length 2^logn over (B, n, 8) words:
// the bit-reversal gather from `in`, the input table `pre` (or null), and
// stages 1..tlog into `out` (tlog = min(logn, 10)); when tlog == logn the
// output multiplies too (`post_c`, `post_t` or null).
extern "C" int inf_fr_ntt_tile(const void* in, void* out, const void* tw,
                               const void* pre, const void* post_c,
                               const void* post_t, int B, int logn, int tlog,
                               void* stream) {
  if (B < 1 || B > 65535 || logn < 0 || logn > 28 || tlog < 0 ||
      tlog > inf::kTileLog || tlog > logn || (tlog < logn && tlog != inf::kTileLog))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(1u << (logn - tlog), B);
  inf::fr_ntt_tile_kernel<<<grid, inf::kTileThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw,
      (const uint32_t*)pre, (const uint32_t*)post_c, (const uint32_t*)post_t,
      logn, tlog);
  return (int)cudaGetLastError();
}

// Stage st (> 10) of B transforms of length 2^logn, in place on `data`;
// the output multiplies where `post_c` / `post_t` are not null.
extern "C" int inf_fr_ntt_stage(void* data, const void* tw, const void* post_c,
                                const void* post_t, int B, int logn, int st,
                                void* stream) {
  if (B < 1 || logn < 1 || logn > 28 || st < 1 || st > logn)
    return (int)cudaErrorInvalidValue;
  const size_t total = size_t(B) << (logn - 1);
  const size_t blocks = (total + inf::kThreads - 1) / inf::kThreads;
  inf::fr_ntt_stage_kernel<<<(unsigned)blocks, inf::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (uint32_t*)data, (const uint32_t*)tw, (const uint32_t*)post_c,
      (const uint32_t*)post_t, logn, st, total);
  return (int)cudaGetLastError();
}

// out[i] = (a[i] [x b[i]] [- c[i]]) [x k] over n values; b, c, k may be
// null. Montgomery products: with k = R^2 mod r it encodes standard-form
// a into Montgomery form, with k = 1 (standard form) it decodes.
extern "C" int inf_fr_pointwise(const void* a, const void* b, const void* c,
                                const void* k, void* out, int n,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + inf::kThreads - 1) / inf::kThreads);
  inf::fr_pointwise_kernel<<<blocks, inf::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (const uint32_t*)k, (uint32_t*)out, size_t(n));
  return (int)cudaGetLastError();
}
