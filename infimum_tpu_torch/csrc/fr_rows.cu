// Sparse R1CS row evaluation over BN254 Fr: for each row j of each
// matrix (A, B, C of a constraint system, or a zkey's A and B), the sum
// over its terms of coeff_k x w[col_k].
//
// Replaces the row evaluation the JAX package compiles in
// infimum_tpu/groth16/rowval.py:92 `_rows_fn`: `_eval_mat` :77 (one
// Montgomery product a term, a segment sum by row) and `_reduce_rows` :63
// (a carry pass, the carry folded back, conditional subtractions). Here
// each row's sum runs in Fr adds, so it is reduced at every step and the
// result equals the plain version's limbs (a reduced Montgomery value).
//
// What bounds it: operations. The process circuit's three matrices hold
// 3,870,593 terms: as many Fr products of 264 multiplies, 0.061 ms at
// 1.67e13 multiplies/s on an H100, against about 0.05 ms to read each
// term's coefficient and column, the witness once (it stays in L2) and
// to write every row. The rows are very uneven (median 1-2 terms, the
// longest 507): one thread a row left most of the card waiting on the
// threads of the longest rows, about 5% of the bound. This design reaches
// about 37%: its products run near 40% of the multiply rate, as the NTT
// tile's do (a product's carry chains share one carry flag). Staging a
// warp's coefficients and witness values in shared memory with cp.async
// before its products, or its witness values alone, ran 51% / 26% slower
// on the card (PERF.md, section 6): the loads are not what it waits on.
//
// Design: merge-path sparse mat-vec (Merrill and Garland, SC16).
// - The items are the terms and the row ends of all nmat x m output rows
//   (empty rows and the domain's padding rows num_rows..m-1 are row ends
//   with no term), in order: row g's terms, then its end. Each thread takes
//   kRowItems consecutive items, a warp 32 x kRowItems, whatever the rows'
//   lengths. groth16/rowval.py `row_partition` finds every thread's start
//   (rows ended and terms before it) once per matrix set and domain, by a
//   binary search over the row ends along the diagonal, and lists the rows
//   that cross a warp's end.
// - A warp first multiplies its terms with neighbouring lanes on
//   neighbouring terms (16-byte coefficient loads and the columns in whole
//   lines; the witness, 4.5 MB at the process shape, is gathered from L2)
//   into its shared memory, word-major. Then each lane walks its items,
//   adding the products (Fr adds) and writing every row whose end it
//   holds, except the first, whose value waits for the lanes before it.
// - The partial sums at the lanes' ends are combined by a segmented scan
//   over the warp's lanes (__shfl_up_sync of the 8 words, Fr adds, reset
//   at a lane that ends a row); each lane that ends a row adds what the
//   lanes before it carry into its first row. So every output row has
//   exactly one writer, and the kernel writes all of them.
// - A warp's carry out (its part of a row that continues past its end)
//   goes to a scratch array; a second small launch adds, for each listed
//   row, the carries of the warps it crosses into the row. No atomics:
//   Fr has none, and a fixed order keeps the run reproducible (Fr addition
//   is exact, so any order gives the same reduced value).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace inf {

constexpr int kRowItems = 8;   // groth16/rowval.py ROW_ITEMS must equal it
constexpr int kWarpItems = 32 * kRowItems;
constexpr int kRowWarps = 4;   // warps a block, six blocks an SM
constexpr int kCarryThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ Fr::E load_row_value(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_row_value(uint32_t* p, const Fr::E& a) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

__device__ __forceinline__ Fr::E shfl_up_value(const Fr::E& a, int off) {
  Fr::E r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = __shfl_up_sync(kFullMask, a.w[w], off);
  return r;
}

// `slices` holds (rows ended, terms) before each thread's items, for
// nwarps x 32 threads and the end; `ends[g]` is the end of output row g's
// terms (g = matrix x m + row); `carry` gets each warp's carry out.
__global__ void __launch_bounds__(32 * kRowWarps, 6)
    fr_rows_kernel(const int32_t* __restrict__ ends,
                   const int32_t* __restrict__ slices,
                   const int32_t* __restrict__ cols,
                   const uint32_t* __restrict__ coeffs,
                   const uint32_t* __restrict__ w, uint32_t* __restrict__ carry,
                   uint32_t* __restrict__ out, int nwarps) {
  __shared__ uint32_t prods[kRowWarps][8][kWarpItems];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int warp = blockIdx.x * kRowWarps + wib;
  if (warp >= nwarps) return;  // whole warps only
  uint32_t(*p)[kWarpItems] = prods[wib];
  const int* sl = slices + 2 * (32 * warp + lane);
  const int i0 = sl[0], j0 = sl[1], i1 = sl[2], j1 = sl[3];
  const int jw = __shfl_sync(kFullMask, j0, 0);
  const int nterms = __shfl_sync(kFullMask, j1, 31) - jw;

  // the warp's products, neighbouring lanes on neighbouring terms
  for (int k = lane; k < nterms; k += 32) {
    const size_t t = size_t(jw) + k;
    const Fr::E x = Fr::mul(load_row_value(coeffs + 8 * t),
                            load_row_value(w + 8 * size_t(cols[t])));
#pragma unroll
    for (int v = 0; v < 8; ++v) p[v][k] = x.w[v];
  }
  __syncwarp();

  // this lane's items: the rows i0..i1-1 end here, terms j0..j1-1
  Fr::E acc = Fr::zero(), first = Fr::zero();
  int k = j0 - jw;
  for (int g = i0; g < i1; ++g) {
    for (const int e = ends[g] - jw; k < e; ++k) {
      Fr::E x;
#pragma unroll
      for (int v = 0; v < 8; ++v) x.w[v] = p[v][k];
      acc = Fr::add(acc, x);
    }
    if (g == i0)
      first = acc;  // waits for what the lanes before carry into it
    else
      store_row_value(out + 8 * size_t(g), acc);
    acc = Fr::zero();
  }
  for (const int e = j1 - jw; k < e; ++k) {
    Fr::E x;
#pragma unroll
    for (int v = 0; v < 8; ++v) x.w[v] = p[v][k];
    acc = Fr::add(acc, x);
  }

  // segmented inclusive scan of the carries over the lanes, reset at a
  // lane that ends a row: x = this lane's carry into row i1 with those of
  // the lanes before it since the last lane that ended a row
  const bool ends_row = i1 > i0;
  bool reset = ends_row;
  Fr::E x = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Fr::E o = shfl_up_value(x, off);
    const bool o_reset = __shfl_up_sync(kFullMask, int(reset), off);
    if (lane >= off) {
      if (!reset) x = Fr::add(x, o);
      reset = reset || o_reset;
    }
  }
  Fr::E in = shfl_up_value(x, 1);
  if (lane == 0) in = Fr::zero();
  if (ends_row) store_row_value(out + 8 * size_t(i0), Fr::add(first, in));
  if (lane == 31) store_row_value(carry + 8 * size_t(warp), x);
}

// For each listed row (row, first warp, end warp): the carries of the
// warps whose end falls inside the row, added into it.
__global__ void __launch_bounds__(kCarryThreads)
    fr_rows_carry_kernel(const int32_t* __restrict__ cross,
                         const uint32_t* __restrict__ carry,
                         uint32_t* __restrict__ out, int ncross) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncross) return;
  const int row = cross[3 * c], a = cross[3 * c + 1], b = cross[3 * c + 2];
  uint32_t* o = out + 8 * size_t(row);
  Fr::E acc = load_row_value(o);
  for (int i = a; i < b; ++i)
    acc = Fr::add(acc, load_row_value(carry + 8 * size_t(i)));
  store_row_value(o, acc);
}

}  // namespace inf

// (nmat, m, 8) words `out`, every row written: row g (= matrix x m + row)
// is the sum over its terms ends[g-1] .. ends[g] - 1 of coeffs[k] x
// w[cols[k]] (Montgomery products), zero for a row with no term. `slices`
// ((nwarps x 32 + 1) x 2 int32) and `cross` (ncross x 3 int32) are
// groth16/rowval.py `row_partition`'s; `carry` is nwarps x 8 words of
// scratch. Two launches: the rows, then the carries across warps.
extern "C" int inf_fr_rows(const void* ends, const void* slices,
                           const void* cross, const void* cols,
                           const void* coeffs, const void* w, void* carry,
                           void* out, int nwarps, int ncross, void* stream) {
  if (nwarps < 0 || ncross < 0 || ncross > nwarps)
    return (int)cudaErrorInvalidValue;
  if (nwarps == 0) return 0;
  const unsigned blocks = (unsigned)((nwarps + inf::kRowWarps - 1) /
                                     inf::kRowWarps);
  inf::fr_rows_kernel<<<blocks, 32 * inf::kRowWarps, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)ends, (const int32_t*)slices, (const int32_t*)cols,
      (const uint32_t*)coeffs, (const uint32_t*)w, (uint32_t*)carry,
      (uint32_t*)out, nwarps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ncross == 0) return (int)err;
  inf::fr_rows_carry_kernel<<<(ncross + inf::kCarryThreads - 1) /
                                  inf::kCarryThreads,
                              inf::kCarryThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cross, (const uint32_t*)carry, (uint32_t*)out, ncross);
  return (int)cudaGetLastError();
}

// threads a block of the row launch
extern "C" int inf_fr_rows_block() { return 32 * inf::kRowWarps; }

// resident blocks an SM of the row launch, or -1
extern "C" int inf_fr_rows_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, inf::fr_rows_kernel, 32 * inf::kRowWarps, 0) != cudaSuccess)
    return -1;
  return n;
}
