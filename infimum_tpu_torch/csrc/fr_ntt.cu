// NTT over BN254 Fr (a tile launch and pass launches of the stages above
// the tile) and the elementwise Fr step of the H pipeline, for batches of
// transforms.
//
// Replaces the XLA programs the JAX package compiles for its H stage:
// infimum_tpu/ntt/ntt.py:121 `_ntt_core` (iterative decimation-in-time
// radix-2, bit reversal first, the packed twiddle table of `_stage_consts`
// :81), its coset forms `_coset_ntt_jit` :206 and `_coset_intt_jit` :219,
// and the pointwise steps of infimum_tpu/groth16/groth16.py:386 `_h_graph`
// (a.b - c, x 1/Z) and the zkey's c = a.b (infimum_tpu/groth16/zkey.py:160,
// gathered by the tile). A value is 8
// little-endian 32-bit words in Montgomery form (R = 2^256), the same
// integer as the plain version's 16 limbs, so every output equals the
// plain version's bit for bit: each step returns a reduced value.
//
// What bounds it: operations. The tile's butterflies, the input table and
// the fused a.b - c are Fr products of 264 multiplies: B = 3 transforms of
// 2^18 with the coset powers, stages 1-11, need 4.33M products (a
// butterfly whose twiddle is 1 needs none), 0.068 ms at 1.67e13
// multiplies/s on an H100, against 0.017 ms to read and write the values
// once at 3.35 TB/s; stages 12-18 of the same need 2.75M products, 0.043
// ms, against 0.018 ms for their values and twiddles once. A product's
// carry chains run in order on one thread (one carry flag), so only other
// warps hide their latency: the tile keeps about 40% of the multiply rate
// (PERF.md, section 6).
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
// - The fused input steps, by gather mode: one input a transform; a.b - c
//   of three (the H stage's coset iNTT input, no pointwise launch before
//   it); or a, b and a.b from two, three transforms out (the zkey's
//   iNTT of its rows, no launch for c = a.b); then an input table at the
//   natural index (the coset powers); when the tile is the whole
//   transform, the output multiplies (a constant, a table) as it writes.
// - Blocks of 256 threads, 64 KB of dynamic shared memory, two blocks
//   an SM (bounds for three left 80 registers, spilled 172 B and ran the
//   process H stage 4% slower).
// Design of the pass launch (stages s0..s1 above the tile, at most
// kPassLog of them, in place; ceil((logn - kTileLog) / kPassLog)
// launches a transform, one for 2^12-2^18): after the tile, stages s0..s1
// only combine positions c + (r << (s0 - 1)) + (g << s1) of one column c
// (c < 2^(s0-1)) and group g, over rows r < 2^(s1-s0+1) = R. A block loads
// all R rows of 2^clog adjacent columns of one group (up to 2^11 values,
// 64 KB) and runs the R-point transform of each column as the tile runs
// its stages: radix-4 groups in registers, two stages between exchanges
// through word-major shared memory, an odd last stage alone, the output
// multiplies fused as it writes back. It reads and writes each value
// once for up to seven stages, where one launch a stage read and wrote
// them seven times. What the design does about:
// - coalescing: a warp takes adjacent columns of one or a few rows, so it
//   reads and writes whole row segments of 2^clog x 32 bytes (clog >= 3:
//   256 bytes or more), never down a column;
// - filling the card: a block holds 2^11 values where the grid still
//   gives every SM two blocks, and fewer columns (down to 8, and one warp
//   a block) where it would not (2^14, and B = 1 at 2^18);
// - bank conflicts: `pass_swz` XORs the low row bits inside a warp's 32
//   banks with row bits 2 and up, so every exchange touches 32 distinct
//   banks a warp a word (tests/test_torch_rows_partition.py checks it);
// - twiddles: stage s's row for the pair at low position p is
//   2^(s-1) - 1 + (p & (2^(s-1) - 1)), the tile's packed table; stages
//   12-18 read 8.3 MB of it, through the read-only cache, and L2 (50 MB)
//   holds it across the batch.
// The pointwise launch: one thread a value, out = (a [x b] [- c]) [x k],
// blocks of kThreads, over the two-chain product (variants in turns,
// PERF.md section 6: 2 or 4 values a thread, and smaller blocks where the
// grid gives an SM few, lost or moved nothing; the one chain of Fr::mul
// took 15-25% more time).
// The leading dim B is the grid's y, so the three transforms of a prove's
// a, b, c run in one launch a pass.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace inf {

constexpr int kTileLog = 11;  // ntt/ntt.py TILE_LOG must equal it
constexpr int kPassLog = 7;   // ntt/ntt.py PASS_LOG must equal it
constexpr int kPassValuesLog = 11;  // values a pass block holds at most
constexpr int kMinColLog = 3;       // columns a pass block at least: 2^3
constexpr int kThreads = 256;
static_assert(kPassLog >= 1 && kPassLog + kMinColLog <= kPassValuesLog,
              "a pass block holds all rows of 8 columns");

// gather modes of the tile launch: one input a transform; a.b - c of
// three; a, b and a.b from two (three transforms out)
constexpr int kGatherValue = 0, kGatherProduct = 1, kGatherAB = 2;

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

// A pass block's shared memory position of value i = row x 2^clog +
// column: the row's bits inside the low five (a warp's rows, clog < 5)
// XORed by its bits 2 and up, so that each exchange's warp hits 32 banks.
__device__ __forceinline__ int pass_swz(int i, int clog) {
  return i ^ (((i >> (clog + 2)) << clog) & 31);
}

// value q (a swizzled position) of word-major shared memory of T values
__device__ __forceinline__ Fr::E smem_load(const uint32_t* s, int T, int q) {
  Fr::E r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = s[w * T + q];
  return r;
}

__device__ __forceinline__ void smem_store(uint32_t* s, int T, int q,
                                           const Fr::E& a) {
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

// The input value at natural index r of a transform whose first input is
// at `src` (later inputs n values apart): the value (take 0), a.b - c
// (take kGatherProduct) or a.b (take kGatherAB), then times pre[r]
__device__ __forceinline__ Fr::E gather(const uint32_t* src,
                                        const uint32_t* pre, size_t r,
                                        size_t n, int take) {
  Fr::E x = load_value(src + 8 * r);
  if (take) {
    x = FrOutOfLine::mul(x, load_value(src + 8 * (n + r)));
    if (take == kGatherProduct)
      x = Fr::sub(x, load_value(src + 8 * (2 * n + r)));
  }
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
                       int tlog, int mode) {
  extern __shared__ uint32_t s[];  // 8 x T words, word-major, swizzled
  const size_t n = size_t(1) << logn;
  const int T = 1 << tlog;
  const int clog = logn - tlog;    // the tile is column blockIdx.x
  const uint32_t col = blockIdx.x;
  const size_t base = size_t(clog ? __brev(col) >> (32 - clog) : 0) << tlog;
  const uint32_t y = blockIdx.y;   // the output transform
  const uint32_t* src;
  int take = mode;
  if (mode == kGatherAB) {         // outputs a, b, a.b of inputs a, b
    src = in + (size_t(y / 3) * 2 + (y % 3 == 1)) * n * 8;
    take = y % 3 == 2 ? kGatherAB : kGatherValue;
  } else {
    src = in + size_t(y) * (mode == kGatherProduct ? 3 : 1) * n * 8;
  }
  uint32_t* dst = out + size_t(y) * n * 8;
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
        x[c] = gather(src, pre, (row << clog) + col, n, take);
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
          smem_store(s, T, swz(4 * g + c), x[c]);
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
      Fr::E x0 = smem_load(s, T, swz(p0)), x1 = smem_load(s, T, swz(p0 + h));
      Fr::E x2 = smem_load(s, T, swz(p0 + 2 * h));
      Fr::E x3 = smem_load(s, T, swz(p0 + 3 * h));
      butterfly(x0, x1, t1);
      butterfly(x2, x3, t1);
      butterfly(x0, x2, load_twiddle(tw + 8 * (2 * h - 1 + k)));
      butterfly(x1, x3, load_twiddle(tw + 8 * (3 * h - 1 + k)));
      if (!last) {
        smem_store(s, T, swz(p0), x0);
        smem_store(s, T, swz(p0 + h), x1);
        smem_store(s, T, swz(p0 + 2 * h), x2);
        smem_store(s, T, swz(p0 + 3 * h), x3);
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
      Fr::E x0 = smem_load(s, T, swz(k)), x1 = smem_load(s, T, swz(k + h));
      butterfly(x0, x1, load_twiddle(tw + 8 * (h - 1 + k)));
      const size_t p = base + k;
      store_value(dst + 8 * p,
                  whole ? post_multiply(x0, post_c, post_t, p) : x0);
      store_value(dst + 8 * (p + h),
                  whole ? post_multiply(x1, post_c, post_t, p + h) : x1);
    }
  }
}

// The twiddle of stage s0 + i of a pass (half = 2^(cs + i), cs = s0 - 1)
// for the pair whose low position in its group is col + (rlow << cs),
// rlow < 2^i: the packed table's row half - 1 + col + (rlow << cs).
__device__ __forceinline__ Fr::E pass_twiddle(const uint32_t* tw, int cs,
                                              int i, size_t col, int rlow) {
  return load_twiddle(tw + 8 * ((size_t(1) << (cs + i)) - 1 + col +
                                (size_t(rlow) << cs)));
}

__global__ void __launch_bounds__(kThreads, 2)
    fr_ntt_pass_kernel(uint32_t* __restrict__ data,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ post_c,
                       const uint32_t* __restrict__ post_t, int logn, int s0,
                       int L, int clog) {
  extern __shared__ uint32_t s[];  // 8 x V words, word-major, swizzled
  const int C = 1 << clog, V = C << L;   // columns, values of the block
  const int cs = s0 - 1;           // log2 of the row stride
  const int chunks_log = cs - clog;
  // the block: columns col0 .. col0 + C - 1 of group blockIdx.x >>
  // chunks_log of transform blockIdx.y
  const size_t col0 = size_t(blockIdx.x & ((1u << chunks_log) - 1)) << clog;
  const size_t base = (size_t(blockIdx.x >> chunks_log) << (cs + L)) + col0;
  uint32_t* a = data + (size_t(blockIdx.y) << logn) * 8;
  const bool post = post_c || post_t;
  const int nv = L >= 2 ? 4 : 2;   // values of a first group

  // stages s0, s0 + 1 on groups of nv consecutive rows, from device memory
  for (int j = threadIdx.x; j < V / nv; j += blockDim.x) {
    const int c = j & (C - 1), r0 = (j >> clog) * nv;
    const size_t col = col0 + c;
    Fr::E x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nv) x[k] = load_value(a + 8 * (base + c + (size_t(r0 + k) << cs)));
    const Fr::E t0 = pass_twiddle(tw, cs, 0, col, 0);
    butterfly(x[0], x[1], t0);
    if (nv == 4) {
      butterfly(x[2], x[3], t0);
      butterfly(x[0], x[2], pass_twiddle(tw, cs, 1, col, 0));
      butterfly(x[1], x[3], pass_twiddle(tw, cs, 1, col, 1));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nv) {
        if (L > 2) {
          smem_store(s, V, pass_swz(((r0 + k) << clog) | c, clog), x[k]);
        } else {
          const size_t p = base + c + (size_t(r0 + k) << cs);
          store_value(a + 8 * p,
                      post ? post_multiply(x[k], post_c, post_t, p) : x[k]);
        }
      }
  }

  // stages s0 + i, s0 + i + 1 on radix-4 groups of rows k + q 4h + {0, h,
  // 2h, 3h} (h = 2^i, k < h), in place; the last writes the output
  int i = 2;
  for (; i + 1 < L; i += 2) {
    __syncthreads();
    const int h = 1 << i;
    const bool last = i + 2 == L;
    for (int j = threadIdx.x; j < V / 4; j += blockDim.x) {
      const int c = j & (C - 1), jj = j >> clog;
      const int k = jj & (h - 1);
      const int r0 = ((jj >> i) << (i + 2)) | k;
      const size_t col = col0 + c;
      Fr::E x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = smem_load(s, V, pass_swz(((r0 + q * h) << clog) | c, clog));
      const Fr::E t1 = pass_twiddle(tw, cs, i, col, k);
      butterfly(x[0], x[1], t1);
      butterfly(x[2], x[3], t1);
      butterfly(x[0], x[2], pass_twiddle(tw, cs, i + 1, col, k));
      butterfly(x[1], x[3], pass_twiddle(tw, cs, i + 1, col, k + h));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!last) {
          smem_store(s, V, pass_swz(((r0 + q * h) << clog) | c, clog), x[q]);
        } else {
          const size_t p = base + c + (size_t(r0 + q * h) << cs);
          store_value(a + 8 * p,
                      post ? post_multiply(x[q], post_c, post_t, p) : x[q]);
        }
      }
    }
  }
  // an odd last stage alone (h = R / 2, rows k and k + h)
  if (L > 2 && i == L - 1) {
    __syncthreads();
    const int h = 1 << i;
    for (int j = threadIdx.x; j < V / 2; j += blockDim.x) {
      const int c = j & (C - 1), k = j >> clog;
      Fr::E x0 = smem_load(s, V, pass_swz((k << clog) | c, clog));
      Fr::E x1 = smem_load(s, V, pass_swz(((k + h) << clog) | c, clog));
      butterfly(x0, x1, pass_twiddle(tw, cs, i, col0 + c, k));
      const size_t p = base + c + (size_t(k) << cs);
      const size_t p1 = p + (size_t(h) << cs);
      store_value(a + 8 * p, post ? post_multiply(x0, post_c, post_t, p) : x0);
      store_value(a + 8 * p1,
                  post ? post_multiply(x1, post_c, post_t, p1) : x1);
    }
  }
}

// out[i] = (a[i] [x b[i]] [- c[i]]) [x k], a thread a value. The products
// are field.cuh's two-carry-chain two_chains::mul<FrParams>, 15-25% less
// time than Fr::mul's one chain at each shape (PERF.md, section 6): its
// one conditional subtraction at the end needs t < 2r there, which holds
// as it does for q since r < 2^254 (R > 4r).
__global__ void __launch_bounds__(kThreads)
    fr_pointwise_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        const uint32_t* __restrict__ c,
                        const uint32_t* __restrict__ k,
                        uint32_t* __restrict__ out, size_t n) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fr::E x = load_value(a + 8 * i);
  if (b) x = two_chains::mul<FrParams>(x, load_value(b + 8 * i));
  if (c) x = Fr::sub(x, load_value(c + 8 * i));
  if (k) x = two_chains::mul<FrParams>(x, load_value(k));
  store_value(out + 8 * i, x);
}

// The tile launch's block and dynamic shared memory at tile 2^tlog: one
// thread a group of 4 values, at most kThreads
int tile_block(int tlog) {
  const int groups = ((1 << tlog) + 3) / 4;
  return groups < kThreads ? groups : kThreads;
}

size_t tile_smem(int tlog) { return tlog > 2 ? size_t(32) << tlog : 0; }

// The pass launch's columns a block, 2^clog, for L stages over B
// transforms of 2^logn on `sms` SMs: 2^kPassValuesLog values a block
// while the grid gives every SM two blocks; fewer columns where it would
// not, down to 2^kMinColLog and to one warp a block.
int pass_col_log(int B, int logn, int L, int sms) {
  const int nvlog = L >= 2 ? 2 : 1;
  const int lo = kMinColLog > 5 + nvlog - L ? kMinColLog : 5 + nvlog - L;
  int clog = kPassValuesLog - L;
  while (clog > lo && (size_t(B) << (logn - L - clog)) < size_t(2) * sms)
    --clog;
  return clog;
}

// threads of a pass block: one a first group, at most kThreads
int pass_block(int L, int clog) {
  const int groups = (1 << (L + clog)) / (L >= 2 ? 4 : 2);
  return groups < kThreads ? groups : kThreads;
}

size_t pass_smem(int L, int clog) {
  return L > 2 ? size_t(32) << (L + clog) : 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return sms;
}

}  // namespace inf

// The first pass of B transforms of length 2^logn: the bit-reversal
// gather from `in`, the input table `pre` (or null), and stages 1..tlog
// into `out` ((B, n, 8) words), tlog = min(logn, kTileLog); when tlog ==
// logn the output multiplies too (`post_c`, `post_t` or null). `in` is
// (B, n, 8) words in mode 0, (B, 3, n, 8) words a, b, c in mode 1 (the
// transform of a.b - c), (B / 3, 2, n, 8) words a, b in mode 2 (the
// transforms of a, b and a.b in turn).
extern "C" int inf_fr_ntt_tile(const void* in, void* out, const void* tw,
                               const void* pre, const void* post_c,
                               const void* post_t, int B, int logn, int tlog,
                               int mode, void* stream) {
  if (B < 1 || B > 65535 || logn < 0 || logn > 28 ||
      tlog != (logn < inf::kTileLog ? logn : inf::kTileLog) || mode < 0 ||
      mode > inf::kGatherAB || (mode == inf::kGatherAB && B % 3))
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
      logn, tlog, mode);
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

// Stages s0..s1 (kTileLog < s0 <= s1 <= logn, at most kPassLog of them)
// of B transforms of length 2^logn, in place on `data` ((B, n, 8) words,
// the tile's output and any passes before); the output multiplies where
// `post_c` / `post_t` are not null.
extern "C" int inf_fr_ntt_pass(void* data, const void* tw, const void* post_c,
                               const void* post_t, int B, int logn, int s0,
                               int s1, void* stream) {
  const int L = s1 - s0 + 1;
  if (B < 1 || B > 65535 || logn > 28 || s0 <= inf::kTileLog || s1 > logn ||
      L < 1 || L > inf::kPassLog)
    return (int)cudaErrorInvalidValue;
  const int sms = inf::sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int clog = inf::pass_col_log(B, logn, L, sms);
  const size_t smem = inf::pass_smem(L, clog);
  const cudaError_t err = cudaFuncSetAttribute(
      inf::fr_ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(size_t(32) << inf::kPassValuesLog));
  if (err != cudaSuccess) return (int)err;
  inf::fr_ntt_pass_kernel<<<dim3(1u << (logn - L - clog), B),
                            inf::pass_block(L, clog), smem,
                            (cudaStream_t)stream>>>(
      (uint32_t*)data, (const uint32_t*)tw, (const uint32_t*)post_c,
      (const uint32_t*)post_t, logn, s0, L, clog);
  return (int)cudaGetLastError();
}

// A pass launch's columns a block (log2) for L stages over B transforms
// of 2^logn on the current card, or -1
extern "C" int inf_fr_ntt_pass_col_log(int B, int logn, int L) {
  const int sms = inf::sm_count();
  if (B < 1 || L < 1 || L > inf::kPassLog || logn - L <= inf::kTileLog - 1 ||
      sms < 1)
    return -1;
  return inf::pass_col_log(B, logn, L, sms);
}

// resident blocks an SM of the pass launch's largest block (2^11 values
// of seven stages), or -1
extern "C" int inf_fr_ntt_pass_blocks_per_sm() {
  const int clog = inf::kPassValuesLog - inf::kPassLog;
  const size_t smem = inf::pass_smem(inf::kPassLog, clog);
  int n = 0;
  if (cudaFuncSetAttribute(inf::fr_ntt_pass_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(size_t(32) << inf::kPassValuesLog)) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, inf::fr_ntt_pass_kernel, inf::pass_block(inf::kPassLog, clog),
          smem) != cudaSuccess)
    return -1;
  return n;
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
