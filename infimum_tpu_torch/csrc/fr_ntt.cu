// NTT over BN254 Fr (a tile launch and one launch a remaining stage) and
// the elementwise Fr step of the H pipeline, for batches of transforms.
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
// What bounds it. The tile launch: operations. Its butterflies, the input
// table and the fused a.b - c are Fr products of 264 multiplies: B = 3
// transforms of 2^18 with the coset powers, stages 1-11, need 4.33M
// products (a butterfly whose twiddle is 1 needs none), 0.068 ms at
// 1.67e13 multiplies/s on an H100, against 0.017 ms to read and write the
// values once at 3.35 TB/s. A product's carry chains run in order on one
// thread (one carry flag), so only other warps hide their latency: the
// kernel keeps about 40% of the multiply rate, as the one-stage-a-sync
// tile before it did, and gains by the products it no longer makes and by
// the stage launch the 2^11 tile saves (PERF.md, section 6). The stage
// launch: device memory, it reads and writes every value once (64 B a
// butterfly) for one product.
//
// Design of the tile launch (one block for 2^tlog consecutive positions
// of one transform, tlog = kTileLog = 11, or all n when n is smaller; 11
// gave the fastest whole H stage at 2^18 of the tiles 2^10-2^12, PERF.md
// section 6):
// - Butterflies in registers: a thread holds 4 values of a radix-4 group
//   and runs two stages on them between exchanges through shared memory,
//   so a tile of 2^11 takes five exchanges and __syncthreads, not eleven.
//   Stages 1 and 2 multiply by 1 but for one butterfly in four (w_4):
//   only that product is made.
// - The gather goes straight into those registers: the first group of a
//   thread is 4 consecutive bit-reversed positions. A block takes the
//   column `blockIdx.x` of the (2^tlog, n / 2^tlog) view of its input,
//   which is the tile brev(blockIdx.x), so the blocks that run together
//   read the neighbouring 32-byte values of the same lines (on the card,
//   a contiguous gather in its place ran no faster: the gather is not
//   what bounds the tile).
// - Shared memory is word-major (word w of position i at w x T + swz(i)),
//   swizzled within each row of 32 positions so that every exchange (the
//   first group's stride-1 positions, the radix-4 groups at h = 4, 16, ...,
//   a last radix-2 stage) touches 32 distinct banks a warp a word
//   (tests/test_torch_rows_partition.py checks it).
// - Twiddles come through the read-only cache (the table of stages
//   1..11 is 64 KB, shared by every block), three a radix-4 group:
//   one for both butterflies of stage s, two for stage s + 1.
// - The fused input steps: a product mode reads (3, n) values a
//   transform and gathers a.b - c (the H stage's coset iNTT input, no
//   pointwise launch before it), and an input table at the natural index
//   (the coset powers); when the tile is the whole transform, the output
//   multiplies (a constant, a table) as it writes.
// - Blocks of 256 threads, 64 KB of dynamic shared memory, two blocks
//   an SM (bounds for three left 80 registers, spilled 172 B and ran the
//   process H stage 4% slower).
// The stage launch: one thread a butterfly of one global stage, in place;
// the last stage fuses the output multiplies: a constant (1/n, and with it
// the exit from Montgomery form, as a constant in standard form) and a
// table indexed by the output position (the inverse coset powers).
// The pointwise launch: one thread a value, out = (a [x b] [- c]) [x k].
// The leading dim B is the grid's y (tile) or folds into the thread index
// (stage), so the three transforms of a prove's a, b, c run in one launch
// a pass.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace inf {

constexpr int kTileLog = 11;  // ntt/ntt.py TILE_LOG must equal it
constexpr int kThreads = 256;

__device__ __forceinline__ Fr::E load_value(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ Fr::E load_twiddle(const uint32_t* p) {
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
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

// The tile's shared memory position of position i: i with its low five
// bits XORed by bits 5-6, so that each exchange's warp hits 32 banks.
__device__ __forceinline__ int swz(int i) {
  return i ^ ((((i >> 5) & 3) * 5) | (((i >> 6) & 1) << 4));
}

__device__ __forceinline__ Fr::E smem_load(const uint32_t* s, int T, int i) {
  const int q = swz(i);
  Fr::E r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = s[w * T + q];
  return r;
}

__device__ __forceinline__ void smem_store(uint32_t* s, int T, int i,
                                           const Fr::E& a) {
  const int q = swz(i);
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w * T + q] = a.w[w];
}

// DIT butterfly (u, v) -> (u + t v, u - t v); without t, t = 1
__device__ __forceinline__ void butterfly(Fr::E& u, Fr::E& v, const Fr::E& t) {
  const Fr::E x = Fr::mul(v, t);
  v = Fr::sub(u, x);
  u = Fr::add(u, x);
}

__device__ __forceinline__ void butterfly(Fr::E& u, Fr::E& v) {
  const Fr::E x = v;
  v = Fr::sub(u, x);
  u = Fr::add(u, x);
}

// The input value at natural index r of a transform at `src`: in product
// mode a.b - c of its three (n, 8) inputs, then times pre[r]
__device__ __forceinline__ Fr::E gather(const uint32_t* src,
                                        const uint32_t* pre, size_t r,
                                        size_t n, bool product) {
  Fr::E x = load_value(src + 8 * r);
  if (product)
    x = Fr::sub(FrOutOfLine::mul(x, load_value(src + 8 * (n + r))),
                load_value(src + 8 * (2 * n + r)));
  if (pre) x = FrOutOfLine::mul(x, load_value(pre + 8 * r));
  return x;
}

__global__ void __launch_bounds__(kThreads, 2)
    fr_ntt_tile_kernel(const uint32_t* __restrict__ in,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ pre,
                       const uint32_t* __restrict__ post_c,
                       const uint32_t* __restrict__ post_t, int logn,
                       int tlog, int product) {
  extern __shared__ uint32_t s[];  // 8 x T words, word-major, swizzled
  const size_t n = size_t(1) << logn;
  const int T = 1 << tlog;
  const int clog = logn - tlog;    // the tile is column blockIdx.x
  const uint32_t col = blockIdx.x;
  const size_t base = size_t(clog ? __brev(col) >> (32 - clog) : 0) << tlog;
  const uint32_t* src = in + size_t(blockIdx.y) * (product ? 3 : 1) * n * 8;
  uint32_t* dst = out + size_t(blockIdx.y) * n * 8;
  const bool whole = clog == 0;
  const int nv = T < 4 ? T : 4;    // values of a first group

  // stages 1 and 2 on groups of 4 consecutive positions, from the gather
  for (int g = threadIdx.x; g < (T + 3) / 4; g += blockDim.x) {
    Fr::E x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nv) {
        const uint32_t i = 4 * g + c;
        const size_t row = tlog ? __brev(i) >> (32 - tlog) : 0;
        x[c] = gather(src, pre, (row << clog) + col, n, product);
      }
    if (tlog >= 1) {
      butterfly(x[0], x[1]);
      if (nv == 4) butterfly(x[2], x[3]);
    }
    if (tlog >= 2) {
      butterfly(x[0], x[2]);
      butterfly(x[1], x[3], load_twiddle(tw + 8 * 2));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nv) {
        if (tlog > 2) {
          smem_store(s, T, 4 * g + c, x[c]);
        } else {
          const size_t p = base + 4 * g + c;
          store_value(dst + 8 * p,
                      whole ? post_multiply(x[c], post_c, post_t, p) : x[c]);
        }
      }
  }

  // stages st, st + 1 on radix-4 groups (positions k + q 4h + {0, h, 2h,
  // 3h}, h = 2^(st-1), k < h), in place; the last pass writes the output
  int st = 3;
  for (; st < tlog; st += 2) {
    __syncthreads();
    const int lh = st - 1, h = 1 << lh;
    const bool last = st + 1 == tlog;
    for (int j = threadIdx.x; j < T / 4; j += blockDim.x) {
      const int k = j & (h - 1);
      const int p0 = ((j >> lh) << (lh + 2)) | k;
      const Fr::E t1 = load_twiddle(tw + 8 * (h - 1 + k));
      Fr::E x0 = smem_load(s, T, p0), x1 = smem_load(s, T, p0 + h);
      Fr::E x2 = smem_load(s, T, p0 + 2 * h), x3 = smem_load(s, T, p0 + 3 * h);
      butterfly(x0, x1, t1);
      butterfly(x2, x3, t1);
      butterfly(x0, x2, load_twiddle(tw + 8 * (2 * h - 1 + k)));
      butterfly(x1, x3, load_twiddle(tw + 8 * (3 * h - 1 + k)));
      if (!last) {
        smem_store(s, T, p0, x0);
        smem_store(s, T, p0 + h, x1);
        smem_store(s, T, p0 + 2 * h, x2);
        smem_store(s, T, p0 + 3 * h, x3);
      } else {
        const Fr::E xs[4] = {x0, x1, x2, x3};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const size_t p = base + p0 + c * h;
          store_value(dst + 8 * p,
                      whole ? post_multiply(xs[c], post_c, post_t, p) : xs[c]);
        }
      }
    }
  }
  // an odd last stage alone (h = T / 2): two butterflies a thread
  if (st == tlog) {
    __syncthreads();
    const int h = T / 2;
    for (int k = threadIdx.x; k < h; k += blockDim.x) {
      Fr::E x0 = smem_load(s, T, k), x1 = smem_load(s, T, k + h);
      butterfly(x0, x1, load_twiddle(tw + 8 * (h - 1 + k)));
      const size_t p = base + k;
      store_value(dst + 8 * p,
                  whole ? post_multiply(x0, post_c, post_t, p) : x0);
      store_value(dst + 8 * (p + h),
                  whole ? post_multiply(x1, post_c, post_t, p + h) : x1);
    }
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

// The tile launch's block and dynamic shared memory at tile 2^tlog: one
// thread a group of 4 values, at most kThreads
int tile_block(int tlog) {
  const int groups = ((1 << tlog) + 3) / 4;
  return groups < kThreads ? groups : kThreads;
}

size_t tile_smem(int tlog) { return tlog > 2 ? size_t(32) << tlog : 0; }

}  // namespace inf

// The first pass of B transforms of length 2^logn over (B, n, 8) words
// (in product mode (B, 3, n, 8) words a, b, c, the transform of a.b - c):
// the bit-reversal gather from `in`, the input table `pre` (or null), and
// stages 1..tlog into `out`, tlog = min(logn, kTileLog); when tlog == logn
// the output multiplies too (`post_c`, `post_t` or null).
extern "C" int inf_fr_ntt_tile(const void* in, void* out, const void* tw,
                               const void* pre, const void* post_c,
                               const void* post_t, int B, int logn, int tlog,
                               int product, void* stream) {
  if (B < 1 || B > 65535 || logn < 0 || logn > 28 ||
      tlog != (logn < inf::kTileLog ? logn : inf::kTileLog) || (product & ~1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = inf::tile_smem(tlog);
  const cudaError_t err = cudaFuncSetAttribute(
      inf::fr_ntt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  inf::fr_ntt_tile_kernel<<<dim3(1u << (logn - tlog), B),
                            inf::tile_block(tlog), smem,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw,
      (const uint32_t*)pre, (const uint32_t*)post_c, (const uint32_t*)post_t,
      logn, tlog, product);
  return (int)cudaGetLastError();
}

// resident blocks an SM of the tile launch of a transform of 2^kTileLog
// or more, or -1
extern "C" int inf_fr_ntt_tile_blocks_per_sm() {
  const size_t smem = inf::tile_smem(inf::kTileLog);
  int n = 0;
  if (cudaFuncSetAttribute(inf::fr_ntt_tile_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, inf::fr_ntt_tile_kernel, inf::tile_block(inf::kTileLog),
          smem) != cudaSuccess)
    return -1;
  return n;
}

// Stage st (above the tile's) of B transforms of length 2^logn, in place
// on `data`; the output multiplies where `post_c` / `post_t` are not null.
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
