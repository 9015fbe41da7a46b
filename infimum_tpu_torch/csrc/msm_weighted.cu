// Weighted bucket reduction for the signed-digit Pippenger MSM.
//
// Replaces infimum_tpu/msm/pallas_msm.py _make_weighted_kernel, launched by
// _weighted_call (grid over windows and 1024-entry chunks, tree reduction
// with 0/1 partner-shift matrices on the MXU).
//
// What it computes: for each window, sum over its compacted emissions e of
// d_e * P_e, which equals sum_d d * B_d (the weights are the bucket
// indices). Entries with digit 0 are padding and skipped.
//
// Design: one block per window. Each thread walks a strided slice of the
// window's entries, computes d * P by double-and-add from the top set bit
// with the complete add (RCB Alg. 7, which also doubles), and sums into its
// own accumulator; the block then tree-reduces the per-thread sums in shared
// memory, limb-major ([word][thread]) so a warp touches 32 banks. Any
// reduction order gives the same window point, which is all that is used.
//
// What bounds it: integer multiply throughput, on few SMs. 20 (G1) or 26
// (G2) blocks leave most of the 132 SMs idle: splitting each window across
// blocks with a second pass is the first thing a performance change should
// do here. `nvcc --resource-usage` for sm_90a, CUDA 12.8: the G1 instance
// uses 128 registers and a 504-byte stack frame (the out-of-line add's
// arguments), 24 bytes of spills; the G2 instance uses 255 registers and a
// 1072-byte stack frame, 64 bytes of spill stores and 136 of spill loads.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

// One out-of-line copy of the complete add: inlined at its three call sites
// the G2 instance made nvcc crash (segmentation fault) on sm_90a.
template <class F>
__device__ __noinline__ Proj<F> add(const Proj<F>& p, const Proj<F>& q) {
  return rcb_add<F>(p, q);
}

template <class F, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
msm_weighted_kernel(const int32_t* __restrict__ cdig,
                    const uint32_t* __restrict__ cpts,
                    uint32_t* __restrict__ out, int K) {
  constexpr int PW = 3 * F::WORDS;
  extern __shared__ uint32_t sh[];  // PW * BLOCK words
  const int tid = threadIdx.x;
  const int32_t* dig = cdig + (size_t)blockIdx.x * K;
  const uint32_t* pts = cpts + (size_t)blockIdx.x * PW * K;

  Proj<F> acc = proj_infinity<F>();
  for (int k = tid; k < K; k += BLOCK) {
    const int32_t d = dig[k];
    if (d == 0) continue;
    const Proj<F> pt = load_proj<F>(pts + k, K);
    Proj<F> part = pt;
    for (int b = 30 - __clz(d); b >= 0; --b) {
      part = add<F>(part, part);
      if ((d >> b) & 1) part = add<F>(part, pt);
    }
    acc = add<F>(acc, part);
  }
  store_proj<F>(sh + tid, BLOCK, acc);
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const Proj<F> a = load_proj<F>(sh + tid, BLOCK);
      const Proj<F> b = load_proj<F>(sh + tid + s, BLOCK);
      store_proj<F>(sh + tid, BLOCK, add<F>(a, b));
    }
    __syncthreads();
  }
  if (tid < PW) out[(size_t)blockIdx.x * PW + tid] = sh[tid * BLOCK];
}

template <class F, int BLOCK>
int launch_weighted(const void* cdig, const void* cpts, void* out, int nwin,
                    int K, void* stream) {
  const size_t shmem = (size_t)3 * F::WORDS * BLOCK * sizeof(uint32_t);
  msm_weighted_kernel<F, BLOCK><<<nwin, BLOCK, shmem, (cudaStream_t)stream>>>(
      (const int32_t*)cdig, (const uint32_t*)cpts, (uint32_t*)out, K);
  return (int)cudaGetLastError();
}

}  // namespace inf

// cdig: (nwin, K) int32; cpts: (nwin, 3W, K) words; out: (nwin, 3W) words.
extern "C" int inf_msm_weighted_g1(const void* cdig, const void* cpts,
                                   void* out, int nwin, int K, void* stream) {
  return inf::launch_weighted<inf::Fq, 256>(cdig, cpts, out, nwin, K, stream);
}

extern "C" int inf_msm_weighted_g2(const void* cdig, const void* cpts,
                                   void* out, int nwin, int K, void* stream) {
  return inf::launch_weighted<inf::Fq2, 128>(cdig, cpts, out, nwin, K,
                                             stream);
}
