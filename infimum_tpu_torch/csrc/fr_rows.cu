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
// What bounds it: device memory, barely. The process circuit's three
// matrices hold about 3.9M terms: 3.9M Fr products of 264 multiplies,
// 0.06 ms at 1.67e13 multiplies/s on an H100, against reading 68 B a term
// (a coefficient, a column and the witness value it names) and writing
// 32 B a row, about 0.09 ms at 3.35 TB/s.
//
// Design (the first, simple one): compressed rows built once per matrix
// set on its device (groth16/rowval.py `SparseRows`): a row pointer over
// the rows of every matrix in turn (nmat x num_rows + 1 int32), the terms'
// columns (int32) and coefficients (8 Montgomery words each), sorted by
// matrix and row. One thread a row of one matrix, all matrices in one
// launch; rows num_rows..m-1 (the domain's padding) are written as zero.
// A thread walks its row alone, so the longest row (507 terms in the
// process circuit's C) sets the time of its warp.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace inf {

constexpr int kRowThreads = 256;

__device__ __forceinline__ Fr::E load_row_value(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__global__ void __launch_bounds__(kRowThreads)
    fr_rows_kernel(const int32_t* __restrict__ rowptr,
                   const int32_t* __restrict__ cols,
                   const uint32_t* __restrict__ coeffs,
                   const uint32_t* __restrict__ w, uint32_t* __restrict__ out,
                   int num_rows, int m, size_t total) {
  const size_t g = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const size_t mat = g / m;
  const int row = int(g - mat * m);
  Fr::E acc = Fr::zero();
  if (row < num_rows) {
    const size_t r = mat * num_rows + row;
    const int end = rowptr[r + 1];
    for (int k = rowptr[r]; k < end; ++k)
      acc = Fr::add(acc, Fr::mul(load_row_value(coeffs + 8 * size_t(k)),
                                 load_row_value(w + 8 * size_t(cols[k]))));
  }
  uint4* o = reinterpret_cast<uint4*>(out + 8 * g);
  o[0] = make_uint4(acc.w[0], acc.w[1], acc.w[2], acc.w[3]);
  o[1] = make_uint4(acc.w[4], acc.w[5], acc.w[6], acc.w[7]);
}

}  // namespace inf

// (nmat, m, 8) words `out`: row j < num_rows of matrix i is the sum over
// terms rowptr[i num_rows + j] .. rowptr[i num_rows + j + 1] - 1 of
// coeffs[k] x w[cols[k]] (Montgomery products), rows num_rows..m-1 zero.
extern "C" int inf_fr_rows(const void* rowptr, const void* cols,
                           const void* coeffs, const void* w, void* out,
                           int num_rows, int m, int nmat, void* stream) {
  if (num_rows < 0 || m < num_rows || nmat < 0)
    return (int)cudaErrorInvalidValue;
  const size_t total = size_t(nmat) * m;
  if (total == 0) return 0;
  const size_t blocks = (total + inf::kRowThreads - 1) / inf::kRowThreads;
  inf::fr_rows_kernel<<<(unsigned)blocks, inf::kRowThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)rowptr, (const int32_t*)cols, (const uint32_t*)coeffs,
      (const uint32_t*)w, (uint32_t*)out, num_rows, m, total);
  return (int)cudaGetLastError();
}
