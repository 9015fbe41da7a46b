// The MSM's layout and compaction: the signed recode, a stable counting sort
// by |digit| and the emission compaction.
//
// Replaces the glue inside infimum_tpu/msm/pallas_msm.py _msm_fn, around its
// two Pallas kernels: the recode scan over the windows (:427-442, a
// lax.scan), each window's stable sort_key_val of the digits against
// arange(N) and the gather of the signs (:444-453), and the compaction of
// the accumulation's emissions (flags, cumsum, .at[dest].set, :456-466).
// On the TPU these are XLA ops inside one compiled program; here they are
// three C entry points, each with a plain torch version in msm/msm.py.
//
// What it computes:
//  1. inf_msm_recode_*: from the scalars as the prover holds them, (n, 8)
//     standard-form words, to what the scatter reads, in one launch. The
//     signed c-bit recode of each scalar, windows in order with the carry,
//     into one packed (nwin, rows) uint16 buffer, |digit| | sign << 15;
//     rows from n on (the query's padding) and rows the query's infinity
//     mask names recode as zero digits, their words never read. Each
//     (block of kChunk rows, window)'s |digit| histogram of 2^(c-1) + 1
//     bins: counts (nwin, nblk, bins). Bin 0 is heavy (the padding rows
//     and the infinity points): a warp adds its zeros with one atomic, the
//     padding rows are added as one count. An item is (block of rows,
//     group of kGroup windows): its threads take pairs of rows, find each
//     scalar's carry into the group's first window by lookahead (the
//     nearest lower window whose raw digit is not 2^(c-1) decides it),
//     recode the group's windows and count them in shared memory. Then,
//     after a grid-wide barrier, the same launch scans the counts: per
//     window and bin the exclusive prefix over the blocks, in place (the
//     offsets), and the bin's total: (nwin, bins).
//     Replaces inf_msm_recode_* (limbs in, a grid of its own for the
//     histograms) and inf_msm_scan (a launch of its own) of commit
//     c6f14c6.
//  2. inf_msm_scatter_*: per (block, window): the window's bin offsets
//     (its totals scanned) and the block's offsets, loaded first. Each of
//     8 warps owns an eighth of the block's entries, read once into
//     registers, and counts them per bin by shared atomics (16-bit
//     counters, the 8 warps' of a bin in one 16-byte vector; a warp's
//     zeros, the heavy bin, added at once); each bin's first position in
//     the block (the block's counts scanned over the bins) and the warps'
//     counts after it in warp order; then each warp walks its entries
//     again, 32 at a time, ranking each among the equal digits of the
//     lanes below by ballots (one __ballot_sync a bit of |digit|: the lanes
//     that agree on every bit are its peers), and stages it at its
//     block-local sorted position, one word (the packed digit above the
//     entry's offset in the block). So equal digits keep their index
//     order: the sort is stable, and equals torch.sort(stable=True) and
//     the reference's sort_key_val. Then thread j writes the j-th staged
//     entry's order and sign to its bin's first slot of the block plus j
//     less the bin's first position there: a bin's run in the block goes
//     to consecutive slots from consecutive threads. sdig over the sorted
//     positions of the block's range, coalesced: each bin starting there
//     marks its first position in shared memory and a running maximum
//     fills the rest. All three are (nwin, N) int32 = the (nwin, L, T) lane
//     layout the accumulation kernel reads.
//  3. inf_msm_compact_*: per window, the live emissions (digit > 0) lane by
//     lane, t rising inside a lane, each to the next of K slots: cdig
//     (nwin, K) and cpts (nwin, PW, K), the slots above the live ones
//     zeroed. Slots first, words after, in three grids: the count (a
//     thread a lane, adjacent lanes adjacent words) of each lane's live
//     emissions; the list (a thread a lane: its first slot from the lane
//     counts before it, then its walk of its emissions, writing each live
//     one's digit to cdig and its source (t, l) to a slot list in the
//     wrapper's scratch); the gather (a thread a (window, slot): its PW
//     words of ept, L words apart, all loads in flight, each store
//     coalesced across the warp). No permuted copy of ept is made.
//
// Grids: the recode a persistent grid of 512 threads a block, as many
// blocks as its items or as fit on the card at once (a cooperative
// launch), items of (block of kChunkG1 = 8,192 rows, 4 windows) at G1 (90
// at the `a` query's 143,360 rows, 18 blocks a window; 160 at `h`),
// (4,096 rows, 4 windows) at G2 (245 at `b2`); the scan one column a
// thread over the grid. The
// scatter a block a (block of entries, window), 360 blocks at `a`
// and 910 at `b2`, the scatter two blocks an SM at G1 (114,720 bytes of
// shared memory each); the compaction's count and list a block of 256
// lanes a window (320 blocks at `a`), its gather a block of 256 slots a
// window (660 at `a`). The chunk sizes the counts array, (nwin, nblk,
// bins) int32: 5.9 MB at `a`.
//
// What bounds it, on an H100: bytes. No field product is done. The
// recode reads a scalar's 32 bytes once from memory (its item's other
// groups find them in the 50 MB L2) and writes packed and the counts
// once; its scan reads and rewrites the counts while they are in L2. In
// practice it waits on its loads: an item's 16 warps walk 8,192 rows in
// 8 steps, each a load of two rows' words before their recode; the
// mask's bytes are read first, all at once, so no load of words waits on
// one of them; the lookahead keeps the recode's arithmetic to the
// group's windows and one more. PERF.md gives the variants it was timed
// against in turns: a larger grid, a prefetch to L2, the scan in the last
// block of a group or in a grid of its own.
// The scatter's slot writes go wherever the digits send them; staged in
// sorted order, a bin's run in a block is stored by consecutive threads
// (about 2 entries a bin a block at G1, 8 at G2), and blocks in launch
// order write adjacent runs of a bin, which the 50 MB L2 merges before
// they reach memory. The compaction's reads of a live emission's words
// are a 32-byte sector each (ept is lane-minor: 24 sectors an emission
// at G1, 48 at G2), its floor; the gather keeps them all in flight.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int kRecodeThreads = 512;
constexpr int kScatterWarps = 8;
constexpr int kScatterThreads = 32 * kScatterWarps;
constexpr int kCompactThreads = 256;
constexpr int kListBatch = 8;  // the compaction's list: loads a lane in flight
// entries a block of the recode's histograms and of the scatter, per curve
constexpr int kChunkG1 = 8192;
constexpr int kChunkG2 = 4096;
// windows a recode item (a block's histograms), per curve
constexpr int kGroupG1 = 4;
constexpr int kGroupG2 = 4;
constexpr int kMaxDevices = 64;

template <int C, int Chunk, int Group>
struct Windows {
  static constexpr int kBits = C;
  static constexpr int kHalf = 1 << (C - 1);
  static constexpr int kBins = kHalf + 1;  // |digit| in [0, 2^(c-1)]
  static constexpr int kCount = (254 + C - 1) / C;
  static constexpr int kChunk = Chunk;
  static constexpr int kGroup = Group;
  static constexpr int kGroups = (kCount + Group - 1) / Group;
  static_assert(Chunk % (32 * kScatterWarps) == 0, "warp ranges of 32s");
  static_assert(Chunk % (2 * kRecodeThreads) == 0, "pairs of rows a thread");
  static_assert(Chunk / kRecodeThreads <= 32, "a thread's mask in a word");
  static_assert(Chunk < 65536, "16-bit counters a warp");
  static_assert(kHalf < 32768, "|digit| below the sign bit");
};
using WindowsG1 = Windows<13, kChunkG1, kGroupG1>;  // 20 windows, 4,097 bins
using WindowsG2 = Windows<10, kChunkG2, kGroupG2>;  // 26 windows, 513 bins

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

// -- 1. recode, block histograms and their scan, one launch ------------------

// The raw c-bit digit of window `win` of a scalar's words w[0..8) (w[8]
// = 0: the top window reaches past bit 255).
template <class P>
__device__ __forceinline__ uint32_t raw_digit(const uint32_t (&w)[9],
                                              int win) {
  const int bit = P::kBits * win, k = bit / 32, s = bit % 32;
  uint32_t raw = w[k] >> s;
  if (s + P::kBits > 32) raw |= w[k + 1] << (32 - s);
  return raw & ((1u << P::kBits) - 1);
}

// The signed recode of window `win`, the carry in and out of `carry`:
// |digit| | sign << 15.
template <class P>
__device__ __forceinline__ uint32_t recode_digit(const uint32_t (&w)[9],
                                                 int win, uint32_t& carry) {
  const uint32_t d = raw_digit<P>(w, win) + carry;
  carry = d > (uint32_t)P::kHalf;
  const uint32_t mag = carry ? 2 * P::kHalf - d : d;
  return mag | carry << 15;
}

// The carry into window W, by lookahead: a window whose raw digit is
// above 2^(c-1) carries out whatever comes in, one below never does, one
// equal passes its carry on; so the nearest window below W whose raw
// digit is not 2^(c-1) decides (almost always W - 1), none: no carry.
template <class P, int W>
__device__ __forceinline__ uint32_t carry_into(const uint32_t (&w)[9]) {
#pragma unroll
  for (int win = W - 1; win >= 0; --win) {
    const uint32_t raw = raw_digit<P>(w, win);
    if (raw != (uint32_t)P::kHalf) return raw > (uint32_t)P::kHalf;
  }
  return 0;
}

// The scalar of row i if `read`, else zero words: nothing is read.
__device__ __forceinline__ void load_scalar(const uint4* __restrict__ words,
                                            int i, bool read, uint32_t (&w)[9]) {
  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  if (read) {
    lo = __ldg(words + 2 * (size_t)i);
    hi = __ldg(words + 2 * (size_t)i + 1);
  }
  w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
  w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
  w[8] = 0;
}

// One item: block `blk` of kChunk rows, the windows of group Grp. The
// block's threads take pairs of rows (2 t + 2 NT j, + 1), find each
// scalar's carry into the group's first window by lookahead, recode the
// group's windows in order, store each window's pair of digits as one
// word of packed and count its |digit| in the window's shared histogram
// (a warp's zeros with one atomic). Rows the mask sets and rows from n
// on hold zero scalars, their words never read; the latter's packed
// digits are stored as zero words and added to bin 0 at once. Then the
// histograms go to the block's row of offsets (counts, scanned later).
template <class P, int Grp>
__device__ void recode_item(const uint4* __restrict__ words,
                            const uint8_t* __restrict__ mask,
                            uint32_t* __restrict__ packed,
                            int32_t* __restrict__ offsets, int32_t* hist,
                            int n, int rows, int nblk, int blk) {
  constexpr int B = P::kBins, G = P::kGroup, NT = kRecodeThreads;
  constexpr int w0 = Grp * G;
  constexpr int w1 = w0 + G < P::kCount ? w0 + G : P::kCount;
  const int lo = blk * P::kChunk, hi = min(rows, lo + P::kChunk);
  const int live_hi = max(lo, min(hi, n));
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < G * B; k += NT) hist[k] = 0;
  __syncthreads();
  if (threadIdx.x == 0 && hi > live_hi)
    for (int win = w0; win < w1; ++win)
      atomicAdd(&hist[(win - w0) * B], hi - live_hi);
  // the mask of this thread's rows first, all its loads at once: bit 2 j
  // + s for row lo + 2 (t + NT j) + s, so no load of words waits on one
  // of the mask
  uint32_t masked = 0;
  if (mask)
    for (int j = 0, i = lo + 2 * threadIdx.x; i < live_hi; ++j, i += 2 * NT)
      masked |= (uint32_t)mask[i] << 2 * j |
                (uint32_t)(i + 1 < live_hi && mask[i + 1]) << (2 * j + 1);
  for (int i0 = lo; i0 < live_hi; i0 += 2 * NT) {  // uniform over the block
    const int i = i0 + 2 * threadIdx.x;
    const bool live0 = i < live_hi, live1 = i + 1 < live_hi;
    uint32_t wa[9], wb[9];
    load_scalar(words, i, live0 && !(masked & 1), wa);
    load_scalar(words, i + 1, live1 && !(masked & 2), wb);
    masked >>= 2;
    uint32_t ca = carry_into<P, w0>(wa), cb = carry_into<P, w0>(wb);
#pragma unroll
    for (int win = w0; win < w1; ++win) {
      const uint32_t da = recode_digit<P>(wa, win, ca);
      const uint32_t db = recode_digit<P>(wb, win, cb);
      if (i < hi) packed[((size_t)win * rows + i) >> 1] = da | db << 16;
      const uint32_t ma = da & 0x7fff, mb = db & 0x7fff;
      const unsigned za = __ballot_sync(~0u, live0 && ma == 0);
      const unsigned zb = __ballot_sync(~0u, live1 && mb == 0);
      int32_t* h = hist + (win - w0) * B;
      if (live0 && ma) atomicAdd(&h[ma], 1);
      if (live1 && mb) atomicAdd(&h[mb], 1);
      if (lane == 0 && (za | zb)) atomicAdd(&h[0], __popc(za) + __popc(zb));
    }
  }
  // the padding rows' digits: zero words from the first pair not stored
  for (int i = ((live_hi + 1) & ~1) + 2 * threadIdx.x; i < hi; i += 2 * NT)
    for (int win = w0; win < w1; ++win)
      packed[((size_t)win * rows + i) >> 1] = 0;
  __syncthreads();
  for (int win = w0; win < w1; ++win) {
    int32_t* out = offsets + ((size_t)win * nblk + blk) * B;
    for (int b = threadIdx.x; b < B; b += NT) out[b] = hist[(win - w0) * B + b];
  }
}

// recode_item<P, grp> for a group known at run time
template <class P, int Grp = 0>
__device__ __forceinline__ void recode_group(
    int grp, const uint4* __restrict__ words, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ packed, int32_t* __restrict__ offsets,
    int32_t* hist, int n, int rows, int nblk, int blk) {
  if constexpr (Grp < P::kGroups) {
    if (grp == Grp)
      recode_item<P, Grp>(words, mask, packed, offsets, hist, n, rows, nblk,
                          blk);
    else
      recode_group<P, Grp + 1>(grp, words, mask, packed, offsets, hist, n,
                               rows, nblk, blk);
  }
}

// One column of the counts, (window, bin) = col: each block's count
// becomes, in place, its exclusive prefix over the blocks; the column's
// sum goes to totals[col]. The counts were written by other blocks of
// this launch: read through L2 (ld.global.cg), never the L1.
template <class P>
__device__ __forceinline__ void scan_column(int32_t* __restrict__ offsets,
                                            int32_t* __restrict__ totals,
                                            int nblk, int col) {
  constexpr int B = P::kBins;
  const int win = col / B, bin = col - win * B;
  int32_t* c = offsets + (size_t)win * nblk * B + bin;
  int32_t run = 0;
  for (int b0 = 0; b0 < nblk; b0 += 16) {  // 16 loads in flight, then stores
    int32_t v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = b0 + k < nblk ? __ldcg(c + (size_t)(b0 + k) * B) : 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (b0 + k < nblk) c[(size_t)(b0 + k) * B] = run;
      run += v[k];
    }
  }
  totals[col] = run;
}

// The recode's items (block of rows, window group), group fastest, so a
// block's groups run side by side and share its words in L2; a block of
// threads walks items from blockIdx.x by gridDim.x. Then, after a
// grid-wide barrier (a cooperative launch: every block is resident), the
// scan of the counts over the blocks, one column a thread of the grid.
template <class P>
__global__ void __launch_bounds__(kRecodeThreads)
msm_recode_kernel(const uint4* __restrict__ words,
                  const uint8_t* __restrict__ mask,
                  uint32_t* __restrict__ packed, int32_t* __restrict__ offsets,
                  int32_t* __restrict__ totals, int n, int rows, int nblk) {
  constexpr int NT = kRecodeThreads;
  extern __shared__ int32_t hist[];  // kGroup x kBins
  const int items = nblk * P::kGroups;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int blk = it / P::kGroups, grp = it - blk * P::kGroups;
    recode_group<P>(grp, words, mask, packed, offsets, hist, n, rows, nblk,
                    blk);
    __syncthreads();
  }
  cooperative_groups::this_grid().sync();
  for (int col = blockIdx.x * NT + threadIdx.x; col < P::kCount * P::kBins;
       col += gridDim.x * NT)
    scan_column<P>(offsets, totals, nblk, col);
}

template <class P>
constexpr size_t recode_smem() {
  return (size_t)P::kGroup * P::kBins * sizeof(int32_t);
}

// resident blocks an SM of the recode instance on the current card, its
// shared memory allowed first; -1 on a failure
template <class P>
int recode_blocks_per_sm() {
  constexpr size_t smem = recode_smem<P>();
  auto* fn = msm_recode_kernel<P>;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                    kRecodeThreads, smem) !=
      cudaSuccess)
    return -1;
  return per_sm;
}

// per card: its SMs, and a recode instance's resident blocks an SM (0:
// not asked yet). Internal linkage: a function's static locals in a
// template would be one object in the whole process (GNU unique
// symbols), shared with another build of this library loaded beside it.
static int g_sms[kMaxDevices];
template <class P>
static int g_recode_per_sm[kMaxDevices];

template <class P>
int launch_recode(const void* words, const void* mask, void* packed,
                  void* offsets, void* totals, int n, int rows, int nblk,
                  void* stream) {
  if (n < 0 || rows < n || rows % 2 ||
      nblk != (rows + P::kChunk - 1) / P::kChunk)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_recode_per_sm<P>[dev]) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    g_recode_per_sm<P>[dev] = recode_blocks_per_sm<P>();
  }
  const int per_sm = g_recode_per_sm<P>[dev];
  if (per_sm < 1) {
    g_recode_per_sm<P>[dev] = 0;
    err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidConfiguration;
  }
  const uint4* w = (const uint4*)words;
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* pk = (uint32_t*)packed;
  int32_t* off = (int32_t*)offsets;
  int32_t* tot = (int32_t*)totals;
  const int items = nblk * P::kGroups;
  constexpr size_t smem = recode_smem<P>();
  void* args[] = {&w, &m, &pk, &off, &tot, &n, &rows, &nblk};
  const int resident = per_sm * g_sms[dev];
  err = cudaLaunchCooperativeKernel((const void*)msm_recode_kernel<P>,
                                    items < resident ? items : resident,
                                    kRecodeThreads, args, smem,
                                    (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // taken, not left behind
  return (int)(err != cudaSuccess ? err : last);
}

// -- 2. stable scatter --------------------------------------------------------

// The lanes of the warp whose d equals this lane's, from one ballot a bit
// of d (d < 2^Bits; the end sentinel kBins fits): the AND of the ballots
// the lane agrees with.
template <int Bits>
__device__ __forceinline__ unsigned ballot_peers(int d) {
  unsigned m = ~0u;
#pragma unroll
  for (int b = 0; b < Bits; ++b) {
    const unsigned v = __ballot_sync(~0u, (d >> b) & 1);
    m &= (d >> b) & 1 ? v : ~v;
  }
  return m;
}

// A counters word of two warps -> each warp's first position in the bin
// from `run`, which moves past both.
__device__ __forceinline__ uint32_t scan_pair(uint32_t w, uint32_t& run) {
  const uint32_t a = w & 0xffff, out = run | (run + a) << 16;
  run += a + (w >> 16);
  return out;
}

// Shared memory a block: the counters (kScatterWarps 16-bit a bin, a
// bin's in one 16-byte vector), the window's bin offsets (B + 1 int32,
// padded to 16 bytes) and the staged chunk (a word an entry). G1: 65,552
// + 16,400 + 32,768 = 114,720 bytes, two blocks an SM; G2: 8,208 + 2,064
// + 16,384.
template <class P>
__host__ __device__ constexpr int base_words() {
  return (P::kBins + 1 + 3) & ~3;
}

template <class P>
constexpr size_t scatter_smem() {
  return (size_t)P::kBins * kScatterWarps * sizeof(uint16_t) +
         base_words<P>() * sizeof(int32_t) +
         (size_t)P::kChunk * sizeof(uint32_t);
}

template <class P>
__global__ void __launch_bounds__(kScatterThreads, 2)
msm_scatter_kernel(const uint16_t* __restrict__ packed,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ totals,
                   int32_t* __restrict__ sdig, int32_t* __restrict__ ssgn,
                   int32_t* __restrict__ order, int n, int nblk) {
  constexpr int B = P::kBins, NW = kScatterWarps, NT = kScatterThreads;
  constexpr int C = P::kChunk, kPerWarp = C / NW, kIters = kPerWarp / 32;
  constexpr int kRun = (B + NT - 1) / NT;  // bins a thread
  static_assert(NW == 8, "a bin's counters are one 16-byte vector");
  static_assert(kRun % 2 == 1, "odd runs: a quarter warp's vectors apart");
  static_assert(C <= 32768, "block-local positions and offsets in 16 bits");
  static_assert((C / NT) % 8 == 0, "a thread's marks in 16-byte vectors");
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* cnt = reinterpret_cast<uint16_t*>(smem);            // B x NW
  uint32_t* cnt32 = reinterpret_cast<uint32_t*>(smem);
  uint4* cnt4 = reinterpret_cast<uint4*>(smem);                 // B
  int32_t* base = reinterpret_cast<int32_t*>(cnt + B * NW);     // B + 1
  uint32_t* stage =
      reinterpret_cast<uint32_t*>(base + base_words<P>());      // C
  __shared__ int32_t warp_sums[NW];
  const int blk = blockIdx.x, win = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const size_t row = (size_t)win * n;

  // loads first: the window's totals and this block's offsets, bin
  // tid + k NT for the k-th, and each warp's eighth of the block's
  // entries, lane l holding entries lo + 32 j + l, digit B past the end
  const int32_t* tot = totals + (size_t)win * B;
  const int32_t* off = offsets + ((size_t)win * nblk + blk) * B;
  int32_t offr[kRun], totr[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int b = threadIdx.x + k * NT;
    totr[k] = b < B ? tot[b] : 0;
    offr[k] = b < B ? off[b] : 0;
  }
  const int b_lo = blk * C, b_hi = min(n, b_lo + C);
  const int lo = b_lo + warp * kPerWarp, hi = min(n, lo + kPerWarp);
  const uint16_t* dig = packed + row;
  uint32_t pk[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int i = lo + 32 * j + lane;
    pk[j] = i < hi ? dig[i] : B;
  }
  for (int b = threadIdx.x; b < B; b += NT) cnt4[b] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kRun; ++k)
    if (threadIdx.x + k * NT < B) base[threadIdx.x + k * NT] = totr[k];
  __syncthreads();
  // the window's bin offsets: its totals scanned
  smem_exclusive_scan<NT>(base, B, warp_sums);

  // each warp's entries per bin: its counter's half of the pair's word,
  // by shared atomics; a warp's zeros (the heavy bin) at once
  const uint32_t one = 1u << 16 * (warp & 1);
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if (lo + 32 * j >= hi) break;  // uniform over the warp
    const int d = pk[j] & 0x7fff;
    const unsigned zeros = __ballot_sync(~0u, d == 0);
    if (d > 0 && d < B) atomicAdd(&cnt32[d * (NW / 2) + (warp >> 1)], one);
    if (lane == 0 && zeros) atomicAdd(&cnt32[warp >> 1], one * __popc(zeros));
  }
  __syncthreads();

  // per bin, its first position in the block (the block's counts scanned
  // over the bins), then the warps' counts in warp order from it: each
  // thread a run of kRun bins, summed, scanned, written back
  {
    const int q0 = min(B, (int)threadIdx.x * kRun), q1 = min(B, q0 + kRun);
    int32_t sum = 0;
    for (int b = q0; b < q1; ++b) {
      const uint4 v = cnt4[b];
      const uint32_t x = v.x + v.y + v.z + v.w;  // no carry: 4 x 1024
      sum += (int32_t)((x & 0xffff) + (x >> 16));
    }
    int32_t unused;
    uint32_t run = (uint32_t)block_exclusive<NT>(sum, warp_sums, unused);
    for (int b = q0; b < q1; ++b) {
      uint4 v = cnt4[b];
      v.x = scan_pair(v.x, run);
      v.y = scan_pair(v.y, run);
      v.z = scan_pair(v.z, run);
      v.w = scan_pair(v.w, run);
      cnt4[b] = v;
    }
  }
  __syncthreads();

  // each entry to its block-local sorted position, 32 at a time in index
  // order, ranked by the ballots: one word, the packed digit above the
  // entry's offset in the block
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if (lo + 32 * j >= hi) break;
    const uint32_t p = pk[j];
    const int d = p & 0x7fff;
    const unsigned m = ballot_peers<P::kBits>(d);
    uint16_t* c = cnt + min(d, B - 1) * NW + warp;
    if (d < B)
      stage[*c + __popc(m & below)] =
          p << 16 | (uint32_t)(warp * kPerWarp + 32 * j + lane);
    __syncwarp();
    if (d < B && !(m & below)) *c += (uint16_t)__popc(m);
    __syncwarp();
  }
  __syncthreads();

  // per bin, the window slot of its first entry in this block less its
  // block-local position, over its first two counters (the last warp's
  // counter of bin b - 1 now holds bin b's first position)
  int32_t* delta = reinterpret_cast<int32_t*>(smem);  // bin b: b * NW / 2
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int b = threadIdx.x + k * NT;
    if (b >= B) break;
    const int32_t start = b ? cnt[b * NW - 1] : 0;
    delta[b * (NW / 2)] = base[b] + offr[k] - start;
  }
  __syncthreads();

  // the staged entries in order: thread j the j-th, so a bin's run in the
  // block goes to consecutive slots from consecutive threads
#pragma unroll 4
  for (int j = threadIdx.x; j < b_hi - b_lo; j += NT) {
    const uint32_t w = stage[j];
    const int32_t dest = j + delta[((w >> 16) & 0x7fff) * (NW / 2)];
    order[row + dest] = b_lo + (int32_t)(w & 0xffff);
    ssgn[row + dest] = (int32_t)(w >> 31);
  }
  __syncthreads();

  // the digits of the sorted positions [b_lo, b_hi) of this block's
  // range: each non-empty bin that starts there marks its first position
  // (over the staged words, done with), then a running maximum over the
  // positions, from the bin that holds b_lo, fills the rest
  uint16_t* mark = reinterpret_cast<uint16_t*>(stage);
  uint4* mark4 = reinterpret_cast<uint4*>(stage);
  constexpr int kPer = C / NT;  // positions a thread
  for (int k = threadIdx.x; k < C / 8; k += NT)
    mark4[k] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += NT) {
    const int s = base[b];
    if (s >= b_lo && s < b_hi && base[b + 1] > s)
      mark[s - b_lo] = (uint16_t)b;
  }
  int a = 0, z = B;  // base[a] <= b_lo < base[z]
  while (z - a > 1) {
    const int mid = (a + z) >> 1;
    if (base[mid] <= b_lo) a = mid; else z = mid;
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
  for (int k = threadIdx.x; k < b_hi - b_lo; k += NT)
    sdig[row + b_lo + k] = mark[k];
}

// (threads, resident blocks an SM on the current card) of a scatter
// instance, its shared memory allowed first; -1 blocks on a failure
template <class P>
int scatter_blocks_per_sm() {
  constexpr size_t smem = scatter_smem<P>();
  if (cudaFuncSetAttribute(msm_scatter_kernel<P>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncSetAttribute(msm_scatter_kernel<P>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, msm_scatter_kernel<P>, kScatterThreads, smem) !=
      cudaSuccess)
    return -1;
  return per_sm;
}

template <class P>
int launch_scatter(const void* packed, const void* offsets, const void* totals,
                   void* sdig, void* ssgn, void* order, int n, int nblk,
                   void* stream) {
  if (n < 0 || nblk != (n + P::kChunk - 1) / P::kChunk)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (scatter_blocks_per_sm<P>() < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidConfiguration;
  }
  msm_scatter_kernel<P><<<dim3(nblk, P::kCount), kScatterThreads,
                          scatter_smem<P>(), (cudaStream_t)stream>>>(
      (const uint16_t*)packed, (const int32_t*)offsets,
      (const int32_t*)totals, (int32_t*)sdig, (int32_t*)ssgn,
      (int32_t*)order, n, nblk);
  return (int)cudaGetLastError();
}

// -- 3. compaction ------------------------------------------------------------

// the count grid: a thread a lane, its live emissions
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

// the list grid: a thread a lane, a block of kCompactThreads lanes a
// window. The block's first slot is the sum of the lane counts before it,
// its lanes' first slots a block scan of theirs; each live lane walks its
// emissions, t rising, kListBatch loads in flight, writing each live
// one's digit to cdig and its source t L + l to the slot list. The block
// then gives its share of the slots above the window's live ones digit 0
// and source -1.
__global__ void __launch_bounds__(kCompactThreads)
msm_compact_list_kernel(const int32_t* __restrict__ edig,
                        const int32_t* __restrict__ lanecnt,
                        int32_t* __restrict__ cdig, int32_t* __restrict__ list,
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
  const int32_t c = l < L ? lc[l] : 0;
  int32_t unused;
  int32_t slot = before + block_exclusive<NT>(c, warp_sums, unused);
  int32_t* cd = cdig + (size_t)win * K;
  int32_t* ls = list + (size_t)win * K;
  if (c > 0) {
    const int32_t* e = edig + (size_t)win * T1 * L + l;
    for (int t0 = 0; t0 < T1; t0 += kListBatch) {
      int32_t d[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u)
        d[u] = t0 + u < T1 ? __ldg(e + (size_t)(t0 + u) * L) : 0;
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (d[u] <= 0) continue;
        if (slot < K) {
          cd[slot] = d[u];
          ls[slot] = (t0 + u) * L + l;
        }
        ++slot;
      }
    }
  }
  const int live = min(all, K);
  const int per = (K - live + gridDim.x - 1) / gridDim.x;
  const int z0 = live + blockIdx.x * per, z1 = min(K, z0 + per);
  for (int s = z0 + threadIdx.x; s < z1; s += NT) {
    cd[s] = 0;
    ls[s] = -1;
  }
}

// the gather grid: a thread a (window, slot), consecutive slots in
// consecutive threads; its PW loads of ept are independent (all in
// flight), and each of its PW stores is coalesced across the warp
template <int PW>
__global__ void __launch_bounds__(kCompactThreads)
msm_compact_gather_kernel(const int32_t* __restrict__ ept,
                          const int32_t* __restrict__ list,
                          int32_t* __restrict__ cpts, int T1, int L, int K) {
  const int s = blockIdx.x * kCompactThreads + threadIdx.x, win = blockIdx.y;
  if (s >= K) return;
  const int32_t at = __ldg(list + (size_t)win * K + s);
  int32_t* out = cpts + (size_t)win * PW * K + s;
  if (at < 0) {
#pragma unroll
    for (int k = 0; k < PW; ++k) out[(size_t)k * K] = 0;
    return;
  }
  const int t = at / L, l = at - t * L;
  const int32_t* src = ept + ((size_t)win * T1 + t) * PW * L + l;
  int32_t v[PW];
#pragma unroll
  for (int k = 0; k < PW; ++k) v[k] = __ldg(src + (size_t)k * L);
#pragma unroll
  for (int k = 0; k < PW; ++k) out[(size_t)k * K] = v[k];
}

template <int PW>
int launch_compact(const void* edig, const void* ept, void* scratch,
                   void* cdig, void* cpts, int nwin, int T1, int L, int K,
                   void* stream) {
  if (nwin < 0 || T1 < 1 || L < 1 || K < 1 || (long long)T1 * L > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (nwin == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* lanecnt = (int32_t*)scratch;
  int32_t* list = lanecnt + (size_t)nwin * L;
  const dim3 lanes((L + kCompactThreads - 1) / kCompactThreads, nwin);
  msm_compact_count_kernel<<<lanes, kCompactThreads, 0, s>>>(
      (const int32_t*)edig, lanecnt, T1, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_compact_list_kernel<<<lanes, kCompactThreads, 0, s>>>(
      (const int32_t*)edig, lanecnt, (int32_t*)cdig, list, T1, L, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_compact_gather_kernel<PW>
      <<<dim3((K + kCompactThreads - 1) / kCompactThreads, nwin),
         kCompactThreads, 0, s>>>((const int32_t*)ept, list, (int32_t*)cpts,
                                  T1, L, K);
  return (int)cudaGetLastError();
}

}  // namespace inf

// words (n, 8) int32 standard-form scalars, mask (>= n) bool or null (true:
// the row's scalar is zero), rows >= n, even -> packed (nwin, rows) uint16,
// offsets (nwin, nblk, bins) int32 (each block's counts scanned over the
// blocks), totals (nwin, bins); nblk = ceil(rows / chunk)
extern "C" int inf_msm_recode_g1(const void* words, const void* mask,
                                 void* packed, void* offsets, void* totals,
                                 int n, int rows, int nblk, void* stream) {
  return inf::launch_recode<inf::WindowsG1>(words, mask, packed, offsets,
                                            totals, n, rows, nblk, stream);
}

extern "C" int inf_msm_recode_g2(const void* words, const void* mask,
                                 void* packed, void* offsets, void* totals,
                                 int n, int rows, int nblk, void* stream) {
  return inf::launch_recode<inf::WindowsG2>(words, mask, packed, offsets,
                                            totals, n, rows, nblk, stream);
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

// edig (nwin, T1, L), ept (nwin, T1, PW, L) int32, scratch (nwin, L + K)
// int32 (the lane counts, then the slot list) -> cdig (nwin, K), cpts
// (nwin, PW, K)
extern "C" int inf_msm_compact_g1(const void* edig, const void* ept,
                                  void* scratch, void* cdig, void* cpts,
                                  int nwin, int T1, int L, int K,
                                  void* stream) {
  return inf::launch_compact<24>(edig, ept, scratch, cdig, cpts, nwin, T1, L,
                                 K, stream);
}

extern "C" int inf_msm_compact_g2(const void* edig, const void* ept,
                                  void* scratch, void* cdig, void* cpts,
                                  int nwin, int T1, int L, int K,
                                  void* stream) {
  return inf::launch_compact<48>(edig, ept, scratch, cdig, cpts, nwin, T1, L,
                                 K, stream);
}

// resident blocks an SM of the recode and scatter instances for each curve
// on the current card (-1 on a failure)
extern "C" int inf_msm_recode_blocks_per_sm_g1() {
  return inf::recode_blocks_per_sm<inf::WindowsG1>();
}

extern "C" int inf_msm_recode_blocks_per_sm_g2() {
  return inf::recode_blocks_per_sm<inf::WindowsG2>();
}

extern "C" int inf_msm_scatter_blocks_per_sm_g1() {
  return inf::scatter_blocks_per_sm<inf::WindowsG1>();
}

extern "C" int inf_msm_scatter_blocks_per_sm_g2() {
  return inf::scatter_blocks_per_sm<inf::WindowsG2>();
}
