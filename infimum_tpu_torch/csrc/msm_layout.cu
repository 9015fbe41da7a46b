// The MSM's layout and compaction: the signed recode, a stable counting sort
// by |digit| and the emission compaction.
//
// Replaces the glue inside infimum_tpu/msm/pallas_msm.py _msm_fn, around its
// two Pallas kernels: the recode scan over the windows (:427-442, a
// lax.scan), each window's stable sort_key_val of the digits against
// arange(N) and the gather of the signs (:444-453), and the compaction of
// the accumulation's emissions (flags, cumsum, .at[dest].set, :456-466).
// On the TPU these are XLA ops inside one compiled program; here they are
// four C entry points, each with a plain torch version in msm/msm.py.
//
// What it computes:
//  1. inf_msm_recode_*: the signed c-bit recode of each scalar, windows in
//     order with the carry (a thread a scalar, its 16 standard-form limbs
//     read as 8 words; bits above 255 are zero, as the reference pads),
//     into one packed (nwin, N) uint16 buffer, |digit| | sign << 15. A
//     second grid counts |digit| per (window, block of kChunk entries) in a
//     shared-memory histogram of 2^(c-1) + 1 bins: counts (nwin, nblk,
//     bins). Bin 0 is heavy (the padding rows and the query's infinity
//     points have zero scalars): a warp adds its zeros with one atomic.
//  2. inf_msm_scan: per window and bin, the exclusive prefix of the counts
//     over the blocks, in place, and the bin's total: (nwin, bins). A small
//     launch of its own, a thread a bin.
//  3. inf_msm_scatter_*: per (block, window): the window's bin offsets (an
//     exclusive scan of its totals in shared memory), the block's first
//     slot of each bin, then each entry to that slot plus its rank among
//     the equal digits before it in the block. Each of 8 warps owns an
//     eighth of the block's entries and counts them per bin (16-bit
//     counters, a row a warp); the warps' counts are scanned in warp
//     order per bin; then each warp walks its entries again, 32 at a
//     time, ranking with __match_any_sync + __popc of the lower lanes.
//     So equal digits keep their index order: the sort is stable, and
//     equals torch.sort(stable=True) and the reference's sort_key_val.
//     A warp reads its entries once, into registers. ssgn and order are
//     written at the slots; sdig over the sorted positions of the block's
//     range, coalesced: each bin starting there marks its first position
//     in shared memory and a running maximum fills the rest. All three are
//     (nwin, N) int32 = the (nwin, L, T) lane layout the accumulation
//     kernel reads.
//  4. inf_msm_compact_*: per window, the live emissions (digit > 0) lane by
//     lane, t rising inside a lane, each to the next of K slots: cdig
//     (nwin, K) and cpts (nwin, PW, K), the slots above the live ones
//     zeroed. A first grid counts each lane's live emissions (a thread a
//     lane, adjacent lanes adjacent words); the second takes its block's
//     first slot from the lanes before it and its lanes' slots by a block
//     scan, then copies only the live emissions' PW words (L words apart
//     in ept) and zeroes its share of the slots above the live ones. No
//     permuted copy of ept is made.
//
// Grids: the recode a thread a scalar; the count and the scatter a block a
// (block of entries, window), 360 blocks at the `a` query (143,360 rows,
// kChunkG1 = 8,192: 18 blocks a window) and 910 at `b2`; the scan a
// thread a (window, bin); the compaction a block of 256 lanes a window
// (320 blocks at `a`, 208 at `b2`). The chunk sizes the counts array,
// (nwin, nblk, bins) int32: 5.9 MB at `a`.
//
// What bounds it, on an H100: bytes. No field product is done. The
// scatter's slot writes land 4 bytes at a time wherever the digit sends
// them, so its stores are the least coalesced; the layout's outputs
// (34 MB at `a`) fit in the 50 MB L2, which merges them.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int kRecodeThreads = 256;
constexpr int kCountThreads = 256;
constexpr int kScanThreads = 256;
constexpr int kScatterWarps = 8;
constexpr int kScatterThreads = 32 * kScatterWarps;
constexpr int kCompactThreads = 256;
// entries a block of the count and scatter grids, per curve
constexpr int kChunkG1 = 8192;
constexpr int kChunkG2 = 4096;

template <int C, int Chunk>
struct Windows {
  static constexpr int kBits = C;
  static constexpr int kHalf = 1 << (C - 1);
  static constexpr int kBins = kHalf + 1;  // |digit| in [0, 2^(c-1)]
  static constexpr int kCount = (254 + C - 1) / C;
  static constexpr int kChunk = Chunk;
  static_assert(Chunk % (32 * kScatterWarps) == 0, "warp ranges of 32s");
  static_assert(Chunk < 65536, "16-bit counters a warp");
  static_assert(kHalf < 32768, "|digit| below the sign bit");
};
using WindowsG1 = Windows<13, kChunkG1>;  // 20 windows, 4,097 bins
using WindowsG2 = Windows<10, kChunkG2>;  // 26 windows, 513 bins

__device__ __forceinline__ int32_t warp_inclusive(int32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The exclusive prefix of v over the block's threads in order; `total`
// gets the block's sum. Every thread of the block calls it.
template <int NT>
__device__ int32_t block_exclusive(int32_t v, int32_t* warp_sums,
                                   int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t x = warp_inclusive(v);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int32_t s = warp_inclusive(lane < NT / 32 ? warp_sums[lane] : 0);
    if (lane < NT / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[NT / 32 - 1];
  const int32_t out = x - v + (warp ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return out;
}

// The running maximum of v over the block's threads before this one, from
// `init`. Every thread of the block calls it.
template <int NT>
__device__ int32_t block_exclusive_max(int32_t v, int32_t init,
                                       int32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x = max(x, y);
  }
  const int32_t below = __shfl_up_sync(~0u, x, 1);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t t = lane < NT / 32 ? warp_sums[lane] : init;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(~0u, t, o);
      if (lane >= o) t = max(t, y);
    }
    if (lane < NT / 32) warp_sums[lane] = t;
  }
  __syncthreads();
  int32_t out = max(init, lane ? below : init);
  if (warp) out = max(out, warp_sums[warp - 1]);
  __syncthreads();
  return out;
}

// a[0..n) in shared memory -> its exclusive prefix, a[n] = the sum: each
// thread scans a contiguous run of ceil(n / NT) (an odd stride at both
// curves' bin counts, so the runs' reads do not collide in a bank)
template <int NT>
__device__ void smem_exclusive_scan(int32_t* a, int n, int32_t* warp_sums) {
  const int per = (n + NT - 1) / NT;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int32_t sum = 0;
  for (int k = lo; k < hi; ++k) sum += a[k];
  int32_t total;
  int32_t run = block_exclusive<NT>(sum, warp_sums, total);
  for (int k = lo; k < hi; ++k) {
    const int32_t v = a[k];
    a[k] = run;
    run += v;
  }
  if (threadIdx.x == 0) a[n] = total;
  __syncthreads();
}

// -- 1. recode and block histograms ------------------------------------------

template <class P>
__global__ void __launch_bounds__(kRecodeThreads)
msm_recode_kernel(const int64_t* __restrict__ sc, uint16_t* __restrict__ packed,
                  int n) {
  const int i = blockIdx.x * kRecodeThreads + threadIdx.x;
  if (i >= n) return;
  const longlong2* row = reinterpret_cast<const longlong2*>(sc) + (size_t)i * 8;
  uint32_t w[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const longlong2 v = __ldg(row + k);
    w[k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
  }
  w[8] = 0;  // the top window reaches past bit 255
  uint32_t carry = 0;
#pragma unroll
  for (int win = 0; win < P::kCount; ++win) {
    constexpr uint32_t mask = (1u << P::kBits) - 1;
    const int bit = P::kBits * win, k = bit / 32, s = bit % 32;
    uint32_t raw = w[k] >> s;
    if (s + P::kBits > 32) raw |= w[k + 1] << (32 - s);
    const uint32_t d = (raw & mask) + carry;
    carry = d > (uint32_t)P::kHalf;
    const uint32_t mag = carry ? 2 * P::kHalf - d : d;
    packed[(size_t)win * n + i] = (uint16_t)(mag | carry << 15);
  }
}

template <class P>
__global__ void __launch_bounds__(kCountThreads)
msm_count_kernel(const uint16_t* __restrict__ packed,
                 int32_t* __restrict__ counts, int n, int nblk) {
  __shared__ int32_t hist[P::kBins];
  const int blk = blockIdx.x, win = blockIdx.y, lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < P::kBins; b += kCountThreads) hist[b] = 0;
  __syncthreads();
  const uint16_t* dig = packed + (size_t)win * n;
  const int lo = blk * P::kChunk, hi = min(n, lo + P::kChunk);
  for (int i0 = lo; i0 < hi; i0 += kCountThreads) {  // uniform over the block
    const int i = i0 + threadIdx.x;
    const int d = i < hi ? (dig[i] & 0x7fff) : -1;
    const unsigned zeros = __ballot_sync(~0u, d == 0);
    if (d > 0) atomicAdd(&hist[d], 1);
    if (lane == 0 && zeros) atomicAdd(&hist[0], __popc(zeros));
  }
  __syncthreads();
  int32_t* out = counts + ((size_t)win * nblk + blk) * P::kBins;
  for (int b = threadIdx.x; b < P::kBins; b += kCountThreads) out[b] = hist[b];
}

template <class P>
int launch_recode(const void* sc, void* packed, void* counts, int n, int nblk,
                  void* stream) {
  if (n < 0 || nblk != (n + P::kChunk - 1) / P::kChunk)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  msm_recode_kernel<P><<<(n + kRecodeThreads - 1) / kRecodeThreads,
                         kRecodeThreads, 0, s>>>((const int64_t*)sc,
                                                 (uint16_t*)packed, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_count_kernel<P><<<dim3(nblk, P::kCount), kCountThreads, 0, s>>>(
      (const uint16_t*)packed, (int32_t*)counts, n, nblk);
  return (int)cudaGetLastError();
}

// -- 2. offsets ---------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
msm_scan_kernel(int32_t* __restrict__ counts, int32_t* __restrict__ totals,
                int nblk, int bins) {
  const int bin = blockIdx.x * kScanThreads + threadIdx.x, win = blockIdx.y;
  if (bin >= bins) return;
  int32_t* c = counts + (size_t)win * nblk * bins + bin;
  int32_t run = 0;
  for (int b0 = 0; b0 < nblk; b0 += 16) {  // 16 loads in flight, then stores
    int32_t v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = b0 + k < nblk ? c[(size_t)(b0 + k) * bins] : 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (b0 + k < nblk) c[(size_t)(b0 + k) * bins] = run;
      run += v[k];
    }
  }
  totals[(size_t)win * bins + bin] = run;
}

// -- 3. stable scatter --------------------------------------------------------

template <class P>
constexpr size_t scatter_smem() {
  return (2 * P::kBins + 1) * sizeof(int32_t) +
         (size_t)kScatterWarps * P::kBins * sizeof(uint16_t);
}

template <class P>
__global__ void __launch_bounds__(kScatterThreads, 2)
msm_scatter_kernel(const uint16_t* __restrict__ packed,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ totals,
                   int32_t* __restrict__ sdig, int32_t* __restrict__ ssgn,
                   int32_t* __restrict__ order, int n, int nblk) {
  constexpr int B = P::kBins, NW = kScatterWarps, NT = kScatterThreads;
  constexpr int kPerWarp = P::kChunk / NW;
  static_assert((NW * B) % 2 == 0, "counters zeroed as 32-bit pairs");
  static_assert((NW * B * sizeof(uint16_t)) % 16 == 0, "aligned after");
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* wcount = reinterpret_cast<uint16_t*>(smem);    // NW x B
  int32_t* base = reinterpret_cast<int32_t*>(wcount + NW * B);  // B + 1
  int32_t* first = base + B + 1;                           // B
  __shared__ int32_t warp_sums[NW];
  const int blk = blockIdx.x, win = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)win * n;

  // the window's bin offsets
  const int32_t* tot = totals + (size_t)win * B;
  for (int b = threadIdx.x; b < B; b += NT) base[b] = tot[b];
  uint32_t* wc32 = reinterpret_cast<uint32_t*>(wcount);
  for (int k = threadIdx.x; k < NW * B / 2; k += NT) wc32[k] = 0;
  __syncthreads();
  smem_exclusive_scan<NT>(base, B, warp_sums);

  // each warp's entries, read once into registers: lane l holds entries
  // lo + 32 j + l, digit B past the end
  constexpr int kIters = kPerWarp / 32;
  const uint16_t* dig = packed + row;
  const int lo = blk * P::kChunk + warp * kPerWarp;
  const int hi = min(n, lo + kPerWarp);
  uint32_t pk[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int i = lo + 32 * j + lane;
    pk[j] = i < hi ? dig[i] : B;
  }

  // each warp's entries per bin
  uint16_t* mine = wcount + warp * B;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if (lo + 32 * j >= hi) break;  // uniform over the warp
    const int d = pk[j] & 0x7fff;
    const unsigned m = __match_any_sync(~0u, d);
    if (d < B && lane == __ffs(m) - 1) mine[d] += (uint16_t)__popc(m);
    __syncwarp();
  }
  __syncthreads();

  // per bin: the warps' offsets in warp order, the block's first slot
  const int32_t* off = offsets + ((size_t)win * nblk + blk) * B;
  for (int b = threadIdx.x; b < B; b += NT) {
    uint16_t run = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const uint16_t v = wcount[k * B + b];
      wcount[k * B + b] = run;
      run += v;
    }
    first[b] = base[b] + off[b];
  }
  __syncthreads();

  // each entry to its slot, 32 at a time in index order
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if (lo + 32 * j >= hi) break;
    const int p = pk[j], d = p & 0x7fff;
    const unsigned m = __match_any_sync(~0u, d);
    if (d < B) {
      const int dest = first[d] + mine[d] + __popc(m & ((1u << lane) - 1));
      order[row + dest] = lo + 32 * j + lane;
      ssgn[row + dest] = p >> 15;
    }
    __syncwarp();
    if (d < B && lane == __ffs(m) - 1) mine[d] += (uint16_t)__popc(m);
    __syncwarp();
  }
  __syncthreads();

  // the digits of the sorted positions [s_lo, s_hi) of this block's range:
  // each non-empty bin that starts there marks its first position (the
  // counters' memory, done with), then a running maximum over the
  // positions, from the bin that holds s_lo, fills the rest
  const int s_lo = blk * P::kChunk, s_hi = min(n, s_lo + P::kChunk);
  uint16_t* mark = wcount;
  constexpr int kPer = P::kChunk / NT;  // positions a thread
  static_assert(kPer % 8 == 0 && P::kChunk <= NW * B, "marks in counters");
  uint4* mark4 = reinterpret_cast<uint4*>(mark);
  for (int k = threadIdx.x; k < P::kChunk / 8; k += NT)
    mark4[k] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += NT) {
    const int s = base[b];
    if (s >= s_lo && s < s_hi && base[b + 1] > s) mark[s - s_lo] = (uint16_t)b;
  }
  int a = 0, z = B;  // base[a] <= s_lo < base[z]
  while (z - a > 1) {
    const int mid = (a + z) >> 1;
    if (base[mid] <= s_lo) a = mid; else z = mid;
  }
  __syncthreads();
  uint4 v[kPer / 8];
#pragma unroll
  for (int q = 0; q < kPer / 8; ++q) v[q] = mark4[threadIdx.x * (kPer / 8) + q];
  uint32_t* w = reinterpret_cast<uint32_t*>(v);
  int32_t top = 0;
#pragma unroll
  for (int k = 0; k < kPer / 2; ++k)
    top = max(top, (int32_t)max(w[k] & 0xffff, w[k] >> 16));
  int32_t run = block_exclusive_max<NT>(top, a, warp_sums);
#pragma unroll
  for (int k = 0; k < kPer / 2; ++k) {
    const uint32_t lo16 = max((uint32_t)run, w[k] & 0xffff);
    const uint32_t hi16 = max(lo16, w[k] >> 16);
    w[k] = lo16 | hi16 << 16;
    run = (int32_t)hi16;
  }
#pragma unroll
  for (int q = 0; q < kPer / 8; ++q) mark4[threadIdx.x * (kPer / 8) + q] = v[q];
  __syncthreads();
  for (int k = threadIdx.x; k < s_hi - s_lo; k += NT)
    sdig[row + s_lo + k] = mark[k];
}

template <class P>
int launch_scatter(const void* packed, const void* offsets, const void* totals,
                   void* sdig, void* ssgn, void* order, int n, int nblk,
                   void* stream) {
  if (n < 0 || nblk != (n + P::kChunk - 1) / P::kChunk)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  constexpr size_t smem = scatter_smem<P>();
  const cudaError_t err = cudaFuncSetAttribute(
      msm_scatter_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  msm_scatter_kernel<P><<<dim3(nblk, P::kCount), kScatterThreads, smem,
                          (cudaStream_t)stream>>>(
      (const uint16_t*)packed, (const int32_t*)offsets,
      (const int32_t*)totals, (int32_t*)sdig, (int32_t*)ssgn,
      (int32_t*)order, n, nblk);
  return (int)cudaGetLastError();
}

// -- 4. compaction ------------------------------------------------------------

__global__ void __launch_bounds__(kCompactThreads)
msm_compact_count_kernel(const int32_t* __restrict__ edig,
                         int32_t* __restrict__ lanecnt, int T1, int L) {
  const int l = blockIdx.x * kCompactThreads + threadIdx.x, win = blockIdx.y;
  if (l >= L) return;
  const int32_t* e = edig + (size_t)win * T1 * L + l;
  int32_t c = 0;
#pragma unroll 8
  for (int t = 0; t < T1; ++t) c += __ldg(e + (size_t)t * L) > 0;
  lanecnt[(size_t)win * L + l] = c;
}

template <int PW>
__global__ void __launch_bounds__(kCompactThreads)
msm_compact_write_kernel(const int32_t* __restrict__ edig,
                         const int32_t* __restrict__ ept,
                         const int32_t* __restrict__ lanecnt,
                         int32_t* __restrict__ cdig, int32_t* __restrict__ cpts,
                         int T1, int L, int K) {
  constexpr int NT = kCompactThreads;
  __shared__ int32_t warp_sums[NT / 32];
  const int win = blockIdx.y, l0 = blockIdx.x * NT, l = l0 + threadIdx.x;
  const int32_t* lc = lanecnt + (size_t)win * L;
  int32_t before = 0, all = 0;
  for (int k = threadIdx.x; k < L; k += NT) {
    const int32_t v = lc[k];
    all += v;
    if (k < l0) before += v;
  }
  block_exclusive<NT>(before, warp_sums, before);
  block_exclusive<NT>(all, warp_sums, all);
  int32_t unused;
  int32_t slot = before + block_exclusive<NT>(l < L ? lc[l] : 0, warp_sums,
                                              unused);
  int32_t* cd = cdig + (size_t)win * K;
  int32_t* cp = cpts + (size_t)win * PW * K;
  if (l < L) {
    const int32_t* e = edig + (size_t)win * T1 * L + l;
    const int32_t* p = ept + (size_t)win * T1 * PW * L + l;
    for (int t = 0; t < T1; ++t) {
      const int32_t d = __ldg(e + (size_t)t * L);
      if (d <= 0) continue;
      if (slot < K) {
        cd[slot] = d;
        const int32_t* src = p + (size_t)t * PW * L;
#pragma unroll
        for (int k = 0; k < PW; ++k)
          cp[(size_t)k * K + slot] = __ldg(src + (size_t)k * L);
      }
      ++slot;
    }
  }
  // this block's share of the slots above the live ones
  const int live = min(all, K);
  const int per = (K - live + gridDim.x - 1) / gridDim.x;
  const int z0 = live + blockIdx.x * per, z1 = min(K, z0 + per);
  for (int s = z0 + threadIdx.x; s < z1; s += NT) {
    cd[s] = 0;
#pragma unroll
    for (int k = 0; k < PW; ++k) cp[(size_t)k * K + s] = 0;
  }
}

template <int PW>
int launch_compact(const void* edig, const void* ept, void* lanecnt,
                   void* cdig, void* cpts, int nwin, int T1, int L, int K,
                   void* stream) {
  if (nwin < 0 || T1 < 1 || L < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (nwin == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((L + kCompactThreads - 1) / kCompactThreads, nwin);
  msm_compact_count_kernel<<<grid, kCompactThreads, 0, s>>>(
      (const int32_t*)edig, (int32_t*)lanecnt, T1, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_compact_write_kernel<PW><<<grid, kCompactThreads, 0, s>>>(
      (const int32_t*)edig, (const int32_t*)ept, (const int32_t*)lanecnt,
      (int32_t*)cdig, (int32_t*)cpts, T1, L, K);
  return (int)cudaGetLastError();
}

}  // namespace inf

// sc (n, 16) int64 standard-form limbs -> packed (nwin, n) uint16, counts
// (nwin, nblk, bins) int32; nblk = ceil(n / chunk)
extern "C" int inf_msm_recode_g1(const void* sc, void* packed, void* counts,
                                 int n, int nblk, void* stream) {
  return inf::launch_recode<inf::WindowsG1>(sc, packed, counts, n, nblk,
                                            stream);
}

extern "C" int inf_msm_recode_g2(const void* sc, void* packed, void* counts,
                                 int n, int nblk, void* stream) {
  return inf::launch_recode<inf::WindowsG2>(sc, packed, counts, n, nblk,
                                            stream);
}

// counts (nwin, nblk, bins) -> their exclusive prefix over the blocks, in
// place; totals (nwin, bins)
extern "C" int inf_msm_scan(void* counts, void* totals, int nwin, int nblk,
                            int bins, void* stream) {
  if (nwin < 0 || nblk < 0 || bins < 1) return (int)cudaErrorInvalidValue;
  if (nwin == 0) return 0;
  inf::msm_scan_kernel<<<dim3((bins + inf::kScanThreads - 1) /
                                  inf::kScanThreads,
                              nwin),
                         inf::kScanThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)counts, (int32_t*)totals, nblk, bins);
  return (int)cudaGetLastError();
}

// packed, the scanned counts and totals -> sdig, ssgn, order (nwin, n) int32
extern "C" int inf_msm_scatter_g1(const void* packed, const void* offsets,
                                  const void* totals, void* sdig, void* ssgn,
                                  void* order, int n, int nblk, void* stream) {
  return inf::launch_scatter<inf::WindowsG1>(packed, offsets, totals, sdig,
                                             ssgn, order, n, nblk, stream);
}

extern "C" int inf_msm_scatter_g2(const void* packed, const void* offsets,
                                  const void* totals, void* sdig, void* ssgn,
                                  void* order, int n, int nblk, void* stream) {
  return inf::launch_scatter<inf::WindowsG2>(packed, offsets, totals, sdig,
                                             ssgn, order, n, nblk, stream);
}

// edig (nwin, T1, L), ept (nwin, T1, PW, L) int32, scratch lanecnt (nwin, L)
// -> cdig (nwin, K), cpts (nwin, PW, K)
extern "C" int inf_msm_compact_g1(const void* edig, const void* ept,
                                  void* lanecnt, void* cdig, void* cpts,
                                  int nwin, int T1, int L, int K,
                                  void* stream) {
  return inf::launch_compact<24>(edig, ept, lanecnt, cdig, cpts, nwin, T1, L,
                                 K, stream);
}

extern "C" int inf_msm_compact_g2(const void* edig, const void* ept,
                                  void* lanecnt, void* cdig, void* cpts,
                                  int nwin, int T1, int L, int K,
                                  void* stream) {
  return inf::launch_compact<48>(edig, ept, lanecnt, cdig, cpts, nwin, T1, L,
                                 K, stream);
}
