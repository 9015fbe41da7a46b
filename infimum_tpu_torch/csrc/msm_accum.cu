// Run-emission bucket accumulation for the signed-digit Pippenger MSM.
//
// Replaces infimum_tpu/msm/pallas_msm.py _make_accum_kernel, launched by
// _accum_call (the TPU's grid over T with the accumulator in VMEM scratch,
// over points that XLA had gathered into a limb-major lane layout).
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
// Design:
//  - The gather is in the kernel. It reads the sorted digits, the signs and
//    the sort's order as torch.sort leaves them, (nwin, L, T) with lane l at
//    l * T + t, and the (N, 2W) row-major table of affine points. A thread
//    reads its entry's row through `order` with 16-byte loads, and before
//    it adds the current entry it issues the next entry's row loads and
//    the digit, sign and row of the one after, so no load is waited on;
//    the table (9-18 MB at the main path's shapes) stays in the 50 MB L2.
//    The TPU needed the points copied into a limb-major layout first (a
//    Pallas TPU kernel cannot gather rows lane by lane); that copy is gone.
//  - One thread per (window, lane), so each lane's walk stays in one thread
//    and in order, and the emissions are what they were.
//  - Blocks of one warp over (lane block, window), the highest lane blocks
//    of every window first. Sorted by |digit|, a window's low lanes hold its
//    zero digits and finish at once: issued last, they fill the last wave
//    instead of leaving it mostly empty. inf_msm_accum_block and
//    inf_msm_accum_blocks_per_sm_* report the block size and the resident
//    blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//  - The products are out of line: G1 runs over FqOutOfLine, G2 over
//    Fq2OutOfLine (field.cuh). Inlined, a G1 mixed add's 11 products are
//    about 100 KB of code a step, more than the instruction cache holds:
//    a chain of mixed adds timed on an H100 ran faster at 8-16 warps an SM
//    with one out-of-line product than with the 11 inlined (PERF.md,
//    section 7).
//  - Dead emissions are not stored (their digit is 0 and the compaction
//    drops them), and zero digits skip both the point's load and the add.
//
// What bounds it, on an H100 (PERF.md, section 6): issuing the Montgomery
// products' multiply-adds and carry chains, 11 Fq products a G1 mixed add
// and 39 a G2 one (13 Fq2 products of 3), at 12 (G1) or 8 (G2) warps an
// SM. nvcc --resource-usage for sm_90a, CUDA 12.9: G1 142 registers, no
// stack; G2 220 registers and a 768-byte stack frame (the Fq2 product's
// operands), no spills. More warps an SM (G1 capped at 128 registers for
// 16) ran slower, not faster. The bytes (digits, signs, order, one read
// of the table, the emissions) are far below the card's rate.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int ACCUM_BLOCK = 32;  // threads (lanes) a block: one warp

template <class F>
__global__ void __launch_bounds__(ACCUM_BLOCK)
msm_accum_kernel(const int32_t* __restrict__ sdig,
                 const int32_t* __restrict__ ssgn,
                 const int32_t* __restrict__ order,
                 const uint4* __restrict__ table, int32_t* __restrict__ edig,
                 uint32_t* __restrict__ ept, int nwin, int T, int L) {
  constexpr int PW = 3 * F::WORDS;
  const int nlb = (L + ACCUM_BLOCK - 1) / ACCUM_BLOCK;
  const int win = blockIdx.x % nwin;
  const int lane =
      (nlb - 1 - (int)blockIdx.x / nwin) * ACCUM_BLOCK + threadIdx.x;
  if (lane >= L) return;
  const size_t in = ((size_t)win * L + lane) * T;
  const int32_t* dig = sdig + in;
  const int32_t* sgn = ssgn + in;
  const int32_t* ord = order + in;
  int32_t* eo = edig + (size_t)win * (T + 1) * L + lane;
  uint32_t* po = ept + (size_t)win * (T + 1) * PW * L + lane;

  // Step t adds entry t, loads entry t + 1's point (its row read at step
  // t - 1) and entry t + 2's digit, sign and row: no load is waited for
  // inside the step that issues it.
  Proj<F> acc = proj_infinity<F>();
  int32_t ad = 0;
  int32_t d = dig[0], s = sgn[0];
  Affine<F> q;
  if (d != 0) q = load_row<F>(table, ord[0]);
  int32_t dn = 0, sn = 0, on = 0;
  if (T > 1) {
    dn = dig[1];
    sn = sgn[1];
    on = ord[1];
  }
  for (int t = 0; t < T; ++t) {
    int32_t dnn = 0, snn = 0, onn = 0;
    if (t + 2 < T) {
      dnn = dig[t + 2];
      snn = sgn[t + 2];
      onn = ord[t + 2];
    }
    Affine<F> qn;
    if (dn != 0) qn = load_row<F>(table, on);
    if (d != 0 && s != 0) q.y = F::neg(q.y);
    if (d == ad) {
      eo[(size_t)t * L] = 0;
      if (d != 0) acc = rcb_add_mixed<F>(acc, q.x, q.y);
    } else {
      eo[(size_t)t * L] = ad;
      if (ad != 0) store_proj<F>(po + (size_t)t * PW * L, L, acc);
      acc = {q.x, q.y, F::one()};
      ad = d;
    }
    d = dn;
    s = sn;
    q = qn;
    dn = dnn;
    sn = snn;
    on = onn;
  }
  eo[(size_t)T * L] = ad;
  store_proj<F>(po + (size_t)T * PW * L, L, acc);
}

template <class F>
int launch_accum(const void* sdig, const void* ssgn, const void* order,
                 const void* words, void* edig, void* ept, int nwin, int T,
                 int L, void* stream) {
  const int nlb = (L + ACCUM_BLOCK - 1) / ACCUM_BLOCK;
  msm_accum_kernel<F><<<nlb * nwin, ACCUM_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sdig, (const int32_t*)ssgn, (const int32_t*)order,
      (const uint4*)words, (int32_t*)edig, (uint32_t*)ept, nwin, T, L);
  return (int)cudaGetLastError();
}

template <class F>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, msm_accum_kernel<F>, ACCUM_BLOCK, 0) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace inf

// sdig, ssgn, order: (nwin, L, T) int32, lane l's sorted entries at
// l * T + t; words: (L * T, 2W) words, 16-byte aligned; edig: (nwin, T+1,
// L) int32; ept: (nwin, T+1, 3W, L) words.
extern "C" int inf_msm_accum_g1(const void* sdig, const void* ssgn,
                                const void* order, const void* words,
                                void* edig, void* ept, int nwin, int T, int L,
                                void* stream) {
  return inf::launch_accum<inf::FqOutOfLine>(sdig, ssgn, order, words, edig,
                                             ept, nwin, T, L, stream);
}

extern "C" int inf_msm_accum_g2(const void* sdig, const void* ssgn,
                                const void* order, const void* words,
                                void* edig, void* ept, int nwin, int T, int L,
                                void* stream) {
  return inf::launch_accum<inf::Fq2OutOfLine>(sdig, ssgn, order, words, edig,
                                              ept, nwin, T, L, stream);
}

// threads (lanes) a block of the accumulation kernel
extern "C" int inf_msm_accum_block() { return inf::ACCUM_BLOCK; }

// resident blocks of ACCUM_BLOCK threads an SM, or -1 on an error
extern "C" int inf_msm_accum_blocks_per_sm_g1() {
  return inf::blocks_per_sm<inf::FqOutOfLine>();
}

extern "C" int inf_msm_accum_blocks_per_sm_g2() {
  return inf::blocks_per_sm<inf::Fq2OutOfLine>();
}
