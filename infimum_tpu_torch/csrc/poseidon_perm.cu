// Circom Poseidon permutation over BN254 Fr, for a batch of states.
//
// Replaces infimum_tpu/hash/poseidon_pallas.py:203-243 (_perm_kernel,
// launched by _perm_call: a grid over 512-lane blocks of the limb-major
// (t, 16, B) state, the whole permutation in VMEM).
//
// What it computes, for each of B states of width t = 2..13: 4 full rounds,
// then PARTIAL_ROUNDS[t-2] partial rounds, then 4 full rounds. Each round
// adds the round's t constants, applies the x^5 S-box (to all t elements in
// a full round, to element 0 in a partial round), then multiplies the state
// by the t x t MDS matrix. Values are Montgomery form (R = 2^256), so the
// output equals the reference's limb for limb.
//
// Design: one thread per state, the state in registers as t x 8 words. The
// kernel is a template on t, so the loops over the state unroll, and one C
// entry switches on t. States are limb-major words [t][8][B]: neighbouring
// threads read neighbouring words. The round constants (rounds, t, 8) and
// the MDS (t, t, 8) are Montgomery words in device memory, passed by
// pointer: every thread of a warp reads the same address, a broadcast.
// `__constant__` memory (64 KB) cannot hold the tables of all widths
// (about 200 KB). Full and partial rounds share one round body with a
// warp-uniform branch on the S-box, which keeps the unrolled code to one
// copy per width. The MDS is t^2 constant Montgomery products plus adds: the
// reference's looped branch (poseidon_pallas.py:186-200). Its fused branch
// for t <= 8 (:45-81, :151-183), one exact-f32 matmul over byte-split limbs
// on the MXU with a lazy reduction, is a TPU trick that does not carry over.
// The MDS row loop stays rolled, its outputs in local memory: with all t^2
// products unrolled, nvcc crashed (segmentation fault) on sm_90a.
//
// What bounds it: 32-bit integer multiplies. At t = 6 a state takes
// 8 x (6 x 3 + 36) + 60 x (3 + 36) = 2,772 Fr products, each about 264
// 32-bit multiplies (CIOS over 8 words), so 2^16 states are about 4.8e10
// multiplies: about 2.9 ms at 64 multiplies per clock per SM on 132 SMs at
// 1.98 GHz. The state moves 2 x 6 x 32 bytes per hash (25 MB for 2^16),
// about 8 us at 3.35 TB/s: negligible. `nvcc --resource-usage` for sm_90a,
// nvcc 12.9 (kernels.py keeps the report): 80 registers at t = 2, 112 at
// t = 6, 168 at t = 13, no spills; the MDS outputs take a stack frame of
// 32 x t bytes.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

__device__ __forceinline__ Fr::E load_const(const uint32_t* __restrict__ p) {
  Fr::E r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __ldg(p + i);
  return r;
}

__device__ __forceinline__ Fr::E sbox(const Fr::E& x) {
  const Fr::E x2 = Fr::mul(x, x);
  const Fr::E x4 = Fr::mul(x2, x2);
  return Fr::mul(x4, x);
}

// One round on the state s: constants `ark` (T x 8 words), S-box on all
// elements when `full`, else on element 0, then s <- MDS * s.
template <int T>
__device__ __forceinline__ void perm_round(Fr::E (&s)[T],
                                           const uint32_t* __restrict__ ark,
                                           const uint32_t* __restrict__ mds,
                                           bool full) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    s[i] = Fr::add(s[i], load_const(ark + 8 * i));
    if (full || i == 0) s[i] = sbox(s[i]);
  }
  Fr::E m[T];  // indexed by the rolled row loop: local memory
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    const uint32_t* row = mds + 8 * i * T;
    Fr::E acc = Fr::mul(load_const(row), s[0]);
#pragma unroll
    for (int j = 1; j < T; ++j)
      acc = Fr::add(acc, Fr::mul(load_const(row + 8 * j), s[j]));
    m[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = m[i];
}

template <int T>
__global__ void __launch_bounds__(128)
poseidon_perm_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ ark,
                     const uint32_t* __restrict__ mds, int rp, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Fr::E s[T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = Fr::load(in + (size_t)i * 8 * B + b, B);
  constexpr int HALF = 4;  // full rounds on each side
  const int rounds = 2 * HALF + rp;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const bool full = r < HALF || r >= HALF + rp;
    perm_round<T>(s, ark + (size_t)r * T * 8, mds, full);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) Fr::store(out + (size_t)i * 8 * B + b, B, s[i]);
}

template <int T>
int launch_perm(const void* in, void* out, const void* ark, const void* mds,
                int rp, int B, void* stream) {
  const dim3 block(128);
  const dim3 grid((B + 127) / 128);
  poseidon_perm_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)ark,
      (const uint32_t*)mds, rp, B);
  return (int)cudaGetLastError();
}

}  // namespace inf

// in, out: (t, 8, B) words; ark: (8 + rp, t, 8) words; mds: (t, t, 8) words,
// all Montgomery form. Returns cudaErrorInvalidValue for a width outside
// 2..13.
extern "C" int inf_poseidon_perm(const void* in, void* out, const void* ark,
                                 const void* mds, int t, int rp, int B,
                                 void* stream) {
  switch (t) {
#define INF_PERM_CASE(T) \
  case T:                \
    return inf::launch_perm<T>(in, out, ark, mds, rp, B, stream);
    INF_PERM_CASE(2)
    INF_PERM_CASE(3)
    INF_PERM_CASE(4)
    INF_PERM_CASE(5)
    INF_PERM_CASE(6)
    INF_PERM_CASE(7)
    INF_PERM_CASE(8)
    INF_PERM_CASE(9)
    INF_PERM_CASE(10)
    INF_PERM_CASE(11)
    INF_PERM_CASE(12)
    INF_PERM_CASE(13)
#undef INF_PERM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
