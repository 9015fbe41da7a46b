// Run-emission bucket accumulation for the signed-digit Pippenger MSM.
//
// Replaces infimum_tpu/msm/pallas_msm.py _make_accum_kernel, launched by
// _accum_call (the TPU's grid over T with the accumulator in VMEM scratch).
//
// What it computes, per window and lane: the lane walks its T entries of the
// window's |digit|-sorted order. Where the sign is set it negates y. While
// the digit repeats it mixed-adds (RCB Alg. 8) the point into a running
// projective sum; when the digit changes it emits (previous digit, sum) and
// restarts the sum at the new point. The final run is emitted at t = T.
// Emitted digit 0 means dead: bucket 0 has weight 0, so zero-digit runs and
// the zero-scalar padding never contribute. The emission contract is the
// reference's, so the compaction after it is the same torch code.
//
// Design: one thread per (window, lane); blockIdx.y is the window, so all
// windows run in one launch (the reference's lax.scan over windows exists
// only for XLA). Entries are limb-major, [window][t][word][lane], as the
// reference's (T, AF, 8, W) blocks: a warp reads 32 consecutive words of
// each coordinate word. Dead emissions are not stored (their digit is 0 and
// the compaction drops them), and zero digits skip the add.
//
// What bounds it: integer multiply throughput and registers. A G1 mixed add
// is 11 Fq products of 64 32x32->64 multiply-adds each, on 8-word limbs; the
// loads are 64 bytes (G1) or 128 bytes (G2) per entry, far below the card's
// bandwidth at these rates. For G2 the accumulator alone is 6 Fq (48
// registers) beside the 4-Fq point and the Karatsuba temporaries.
// `nvcc --resource-usage` (kernels.py keeps its report) for sm_90a, CUDA
// 12.8: the G1 instance uses 145 registers and no spills; the G2 instance
// uses 255 registers with 48 bytes of spill stores and loads.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

template <class F>
__global__ void __launch_bounds__(128)
msm_accum_kernel(const int32_t* __restrict__ sdig,
                 const int32_t* __restrict__ ssgn,
                 const uint32_t* __restrict__ spts, int32_t* __restrict__ edig,
                 uint32_t* __restrict__ ept, int T, int L) {
  constexpr int W = F::WORDS;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const size_t in_row = (size_t)blockIdx.y * T;
  const size_t out_row = (size_t)blockIdx.y * (T + 1);

  Proj<F> acc = proj_infinity<F>();
  int32_t ad = 0;
  for (int t = 0; t < T; ++t) {
    const size_t r = in_row + t;
    const int32_t d = sdig[r * L + lane];
    const uint32_t* p = spts + r * (2 * W) * L + lane;
    const typename F::E px = F::load(p, L);
    typename F::E py = F::load(p + (size_t)W * L, L);
    if (ssgn[r * L + lane]) py = F::neg(py);
    const size_t o = out_row + t;
    if (d == ad) {
      edig[o * L + lane] = 0;
      if (d != 0) acc = rcb_add_mixed<F>(acc, px, py);
    } else {
      edig[o * L + lane] = ad;
      if (ad != 0) store_proj<F>(ept + o * (3 * W) * L + lane, L, acc);
      acc = {px, py, F::one()};
      ad = d;
    }
  }
  const size_t o = out_row + T;
  edig[o * L + lane] = ad;
  store_proj<F>(ept + o * (3 * W) * L + lane, L, acc);
}

template <class F>
int launch_accum(const void* sdig, const void* ssgn, const void* spts,
                 void* edig, void* ept, int nwin, int T, int L, void* stream) {
  const dim3 block(128);
  const dim3 grid((L + 127) / 128, nwin);
  msm_accum_kernel<F><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sdig, (const int32_t*)ssgn, (const uint32_t*)spts,
      (int32_t*)edig, (uint32_t*)ept, T, L);
  return (int)cudaGetLastError();
}

}  // namespace inf

// sdig, ssgn: (nwin, T, L) int32; spts: (nwin, T, 2W, L) words;
// edig: (nwin, T+1, L) int32; ept: (nwin, T+1, 3W, L) words.
extern "C" int inf_msm_accum_g1(const void* sdig, const void* ssgn,
                                const void* spts, void* edig, void* ept,
                                int nwin, int T, int L, void* stream) {
  return inf::launch_accum<inf::Fq>(sdig, ssgn, spts, edig, ept, nwin, T, L,
                                    stream);
}

extern "C" int inf_msm_accum_g2(const void* sdig, const void* ssgn,
                                const void* spts, void* edig, void* ept,
                                int nwin, int T, int L, void* stream) {
  return inf::launch_accum<inf::Fq2>(sdig, ssgn, spts, edig, ept, nwin, T, L,
                                     stream);
}
