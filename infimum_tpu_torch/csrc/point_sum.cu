// The sharded MSM's cross-rank sum of window sums, G1 and G2.
//
// Replaces infimum_tpu/parallel/msm.py _tree_reduce_axis0 (:31, an XLA
// program inside shard_map: masked halving in a fori_loop of complete
// adds) and the permute round's curve.add (:127). In the port both ran as
// one complete add in plain torch a level, about 2,000 launches a round.
//
// What it computes: D projective points a window, (D, nwin, PW) words,
// summed to (nwin, PW). The order is the plain version's (parallel/msm.py
// `_tree_reduce_axis0`): padded with infinity (0, 1, 0) to a power of two
// T >= D, then halved, entry i plus entry i + T/2, until one is left. Each
// add is field.cuh's rcb_add (RCB Alg. 7), the formula of curve/proj.py
// `add`, so the output equals the plain version's limbs bit for bit. It
// takes D >= 2 (the wrapper returns D = 1's one entry as it is); the
// permute round is D = 2 (mine, then my partner's).
//
// Design: one thread a window, walking the halving levels in order; the
// first level reads the input (infinity above D), the levels after it
// read and write the scratch, (T/2, nwin, PW) words, in place (entry i
// is written after entries i and i + half are read; i < half), and the
// last writes the output. The complete add is one out-of-line function
// (the G2 add inlined at several sites made nvcc crash on sm_90a,
// msm_weighted.cu). A round is a few adds on 20 or 26 threads: what bounds
// it is the latency of one dependent chain of log2(T) levels, not the
// card's rates.
#include <cuda_runtime.h>

#include "field.cuh"

namespace inf {

constexpr int kSumBlock = 32;

template <class F>
__device__ __noinline__ Proj<F> sum_add(const Proj<F>& p, const Proj<F>& q) {
  return rcb_add<F>(p, q);
}

// the offset of entry i of a (rows, nwin, PW) words array, for window w
template <class F>
__device__ __forceinline__ size_t at(int i, int w, int nwin) {
  return ((size_t)i * nwin + w) * 3 * F::WORDS;
}

template <class F>
__global__ void __launch_bounds__(kSumBlock)
point_sum_kernel(const uint32_t* __restrict__ in, uint32_t* scratch,
                 uint32_t* __restrict__ out, int D, int nwin) {
  const int w = blockIdx.x * kSumBlock + threadIdx.x;
  if (w >= nwin) return;
  int half = 1;
  while (2 * half < D) half *= 2;  // T = 2 half >= D > half
  // the first level: entry i < half < D is real; i + half may be padding
  for (int i = 0; i < half; ++i) {
    const Proj<F> a = load_proj<F>(in + at<F>(i, w, nwin), 1);
    const Proj<F> b = i + half < D
                          ? load_proj<F>(in + at<F>(i + half, w, nwin), 1)
                          : proj_infinity<F>();
    store_proj<F>((half == 1 ? out : scratch) + at<F>(i, w, nwin), 1,
                  sum_add<F>(a, b));
  }
  for (half /= 2; half >= 1; half /= 2) {
    for (int i = 0; i < half; ++i) {
      const Proj<F> a = load_proj<F>(scratch + at<F>(i, w, nwin), 1);
      const Proj<F> b = load_proj<F>(scratch + at<F>(i + half, w, nwin), 1);
      store_proj<F>((half == 1 ? out : scratch) + at<F>(i, w, nwin), 1,
                    sum_add<F>(a, b));
    }
  }
}

template <class F>
int launch_point_sum(const void* in, void* scratch, void* out, int D,
                     int nwin, void* stream) {
  if (D < 2 || nwin < 1) return (int)cudaErrorInvalidValue;
  point_sum_kernel<F><<<(nwin + kSumBlock - 1) / kSumBlock, kSumBlock, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)scratch, (uint32_t*)out, D, nwin);
  return (int)cudaGetLastError();
}

}  // namespace inf

// in: (D, nwin, 3W) projective words, D >= 2; scratch: (T/2, nwin, 3W) words for
// T the power of two >= D (read and written from T = 4 on; may be null
// below); out: (nwin, 3W) words.
extern "C" int inf_point_sum_g1(const void* in, void* scratch, void* out,
                                int D, int nwin, void* stream) {
  return inf::launch_point_sum<inf::FqOutOfLine>(in, scratch, out, D, nwin,
                                                 stream);
}

extern "C" int inf_point_sum_g2(const void* in, void* scratch, void* out,
                                int D, int nwin, void* stream) {
  return inf::launch_point_sum<inf::Fq2OutOfLine>(in, scratch, out, D, nwin,
                                                  stream);
}
