// Fixed-base windowed multiply [s_i] G of many scalars by one generator,
// G1 and G2: the workload of Groth16 setup and zkey generation, every key
// element a known scalar times a generator.
//
// Replaces infimum_tpu/msm/fixed_base.py _kernel (a jax.jit program, :59,
// not Pallas): there XLA gathers one table point per 8-bit window of each
// scalar, masks the zero digits to infinity and folds the 32 windows with
// a scan of complete adds, over chunks of scalars.
//
// What it computes: the table holds tab[w][d] = d * 2^(8w) * G as affine
// Montgomery points, 32 windows x 256 digits (the digit-0 slot of each
// window holds a dummy generator and is never read). One thread a scalar
// walks its 32 windows in ascending order, digit w = bits 8w..8w+7 of the
// standard-form scalar (below r), starting from infinity, and mixed-adds
// (RCB Alg. 8, field.cuh rcb_add_mixed) the window's point where the digit
// is not 0. That is the plain version's order (msm/fixed_base.py
// `_mul_chunk`, whose add_mixed is the same formula), so the projective
// output equals its limbs bit for bit.
//
// Design: the table (512 KB for G1, 1 MB for G2) is read with 16-byte
// loads and stays in the 50 MB L2; each thread loads its scalar's 32 bytes
// once and takes each digit from the low byte of its 256-bit value, which
// it then shifts right by 8 (funnel shifts in registers, no indexed local
// array). No chunks: one launch covers every scalar of a call. The
// products are out of line, as in msm_accum.cu: FqOutOfLine for G1,
// Fq2OutOfLine for G2 (inlined, an Fq2 mixed add spills).
//
// What bounds it, on an H100: the Montgomery products' multiplies, 11 Fq
// products a G1 mixed add and 39 a G2 one, one add a nonzero digit (up to
// 32 a scalar). The bytes (32 a scalar in, 96 or 192 out) are far below.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int kC = 8;          // bits a window: = msm/fixed_base.py C
constexpr int kWindows = 32;   // windows a scalar: = N_WINDOWS
constexpr int kFixedBlock = 128;

template <class F>
__global__ void __launch_bounds__(kFixedBlock)
fixed_base_kernel(const uint4* __restrict__ scalars,
                  const uint4* __restrict__ table, uint32_t* __restrict__ out,
                  int n) {
  const int i = blockIdx.x * kFixedBlock + threadIdx.x;
  if (i >= n) return;
  uint32_t s[8];
  {
    const uint4 lo = __ldg(scalars + 2 * (size_t)i);
    const uint4 hi = __ldg(scalars + 2 * (size_t)i + 1);
    s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
    s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
  }
  Proj<F> acc = proj_infinity<F>();
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
  store_proj<F>(out + (size_t)i * 3 * F::WORDS, 1, acc);
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

}  // namespace inf

// scalars: (n, 8) standard-form words below r, 16-byte aligned; table:
// (kWindows << kC, 2W) affine Montgomery words, row w * 256 + d holding
// d * 2^(8w) * G (x then y); out: (n, 3W) projective words, X then Y then Z.
extern "C" int inf_fixed_base_g1(const void* scalars, const void* table,
                                 void* out, int n, void* stream) {
  return inf::launch_fixed_base<inf::FqOutOfLine>(scalars, table, out, n,
                                                  stream);
}

extern "C" int inf_fixed_base_g2(const void* scalars, const void* table,
                                 void* out, int n, void* stream) {
  return inf::launch_fixed_base<inf::Fq2OutOfLine>(scalars, table, out, n,
                                                   stream);
}
