// Circom Poseidon permutation over BN254 Fr, for a batch of states, in the
// optimized form: folded round constants and sparse partial rounds.
//
// Replaces infimum_tpu/hash/poseidon_pallas.py:223 (_perm_call, the
// pallas_call at :236 over _perm_kernel :203 and the rounds of _perm_body
// :116: a grid over 512-lane blocks of the limb-major (t, 16, B) state,
// the dense permutation in VMEM).
//
// What it computes, for each of B states of width t = 2..13: the reference's
// 4 full + R_P partial + 4 full rounds (constants, x^5 S-box, s <- MDS * s)
// rewritten as in the Poseidon paper's App. B and circomlib's optimized
// poseidon.circom (hash/poseidon_sparse.py derives the tables and says
// why they are equal): the constants C are folded so that a partial round
// adds one constant to element 0 after its S-box; the full round before the
// partial ones mixes with a matrix P; each partial round mixes with a sparse
// matrix S_j, a first row and a first column. Values are Montgomery form
// (R = 2^256), so the output equals the reference's limb for limb.
//
// What bounds it: 32-bit integer multiplies. At t = 6 a state takes
// 8 x (6 x 3 + 36) + 60 x (3 + 6 + 5) = 1,272 Fr products, each 264
// multiplies (CIOS over 8 words): 2^16 states are 2.2e10 multiplies,
// 1.316 ms at 132 SMs x 64 a clock x 1,980 MHz = 1.6727e13/s on an
// NVIDIA H100 80GB HBM3 at 700 W. Summing each matrix
// row's t products with one Montgomery reduction (sum_of_products) needs
// 128 t + 136 multiplies a row instead of 264 t: 262,368 a state at t = 6,
// 1.028 ms for 2^16 states. The state moves 2 x 6 x 32 bytes a hash
// (25 MB for 2^16, 8 us at 3.35 TB/s).
//
// Design: one thread per state, the state in registers as t x 8 words; the
// kernel is a template on t, so the loops over the state unroll, and one C
// entry switches on t. States are limb-major words [t][8][B]: neighbouring
// threads read neighbouring words.
// - Partial rounds: one S-box (3 products), then the sparse mix: the new
//   element 0 is one sum of t products, and the column t - 1 products, all
//   unrolled over t with no array in local memory; the R_P loop stays
//   rolled.
// - Full rounds: one rolled loop over the 8 rounds (the partial rounds
//   inside it after the fourth), and a rolled loop over the matrix rows,
//   each row one sum of t products. Each row's sum is shifted into the
//   last of t output registers, the others moving down one, so the rolled
//   loop indexes no array by a variable and nothing goes to local memory.
// - Sums of products: CIOS over all t products at once, its word loop
//   rolled (each step loads one word of each constant), so the code of a
//   sum is about 150 instructions at t = 6 and stays in the instruction
//   cache. Variant 7 sums each row as t reduced products instead.
// - Tables: every thread of a block reads the same constant at the same
//   time, a broadcast. They are read either from device memory through
//   the read-only cache (__ldg) or from shared memory, staged once per
//   block (27 KB at t = 6, 64 KB at t = 13: above 48 KB only with
//   cudaFuncAttributeMaxDynamicSharedMemorySize). The other products (the
//   S-boxes, a partial round's column) are either inlined (Fr) or one
//   out-of-line function (FrOutOfLine). The variants are built at t = 6
//   and timed by chip_smoke.py phase 7(d); the main instance (PermField,
//   kPermSmem below) is the fastest there (PERF.md, section 6).
// Registers and stack (nvcc 12.9 --resource-usage for sm_90a, which
// kernels.py keeps and chip_smoke.py prints per width): 128 registers at
// t = 3, 160 at t = 5, 176 at t = 6, 255 at t = 11-13 with a 64 and
// 128-byte frame at t = 12 and 13 (16 bytes of spill stores); no stack
// below t = 12 and none in FrOutOfLine::mul.
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

namespace inf {

// The main instance, chosen by measurement at t = 6 (PERF.md, section 6).
using PermField = FrOutOfLine;
constexpr bool kPermSmem = true;

constexpr int kPermBlock = 128;
constexpr int kFullRounds = 8;
constexpr int kHalf = kFullRounds / 2;

// One Montgomery constant: two 16-byte loads, from shared memory or through
// the read-only cache.
template <bool SMEM>
__device__ __forceinline__ Fr::E load_const(const uint4* p) {
  const uint4 lo = SMEM ? p[0] : __ldg(p);
  const uint4 hi = SMEM ? p[1] : __ldg(p + 1);
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// One 32-bit word of a Montgomery constant.
template <bool SMEM>
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  return SMEM ? *p : __ldg(p);
}

// sum_j k_j * s_j * 2^-256 mod r over T terms with one Montgomery reduction
// a row: CIOS over all T products at once. Row i adds s_j * (word i of
// k_j) for every j, then m * r with m = -t[0] / r mod 2^32, and shifts t
// down a word. With every k_j, s_j < r, t stays below 2^291 (10 words)
// and ends below (0.19 T + 1) r < 4r, so 1 to 3 conditional subtractions
// reduce it. 128 T + 136 multiplies where T products take 264 T. The row
// loop stays rolled: word i of each k_j is a load, so no register array is
// indexed by the loop. `k` points at T constants of 8 words each.
template <int T, bool SMEM>
__device__ __forceinline__ Fr::E sum_of_products(const uint32_t* k,
                                                 const Fr::E (&s)[T]) {
  uint32_t t[10];
#pragma unroll
  for (int w = 0; w < 10; ++w) t[w] = 0;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t kw = load_word<SMEM>(k + 8 * j + i);
      t[0] = ptx::mad_lo_cc(s[j].w[0], kw, t[0]);
#pragma unroll
      for (int w = 1; w < 8; ++w)
        t[w] = ptx::madc_lo_cc(s[j].w[w], kw, t[w]);
      t[8] = ptx::addc_cc(t[8], 0);
      t[9] = ptx::addc(t[9], 0);
      t[1] = ptx::mad_hi_cc(s[j].w[0], kw, t[1]);
#pragma unroll
      for (int w = 1; w < 8; ++w)
        t[w + 1] = ptx::madc_hi_cc(s[j].w[w], kw, t[w + 1]);
      t[9] = ptx::addc(t[9], 0);
    }
    const uint32_t m = t[0] * FrParams::INV;
    ptx::mad_lo_cc(m, FrParams::p(0), t[0]);
#pragma unroll
    for (int w = 1; w < 8; ++w)
      t[w] = ptx::madc_lo_cc(m, FrParams::p(w), t[w]);
    t[8] = ptx::addc_cc(t[8], 0);
    t[9] = ptx::addc(t[9], 0);
    t[1] = ptx::mad_hi_cc(m, FrParams::p(0), t[1]);
#pragma unroll
    for (int w = 1; w < 8; ++w)
      t[w + 1] = ptx::madc_hi_cc(m, FrParams::p(w), t[w + 1]);
    t[9] = ptx::addc(t[9], 0);
#pragma unroll
    for (int w = 0; w < 9; ++w) t[w] = t[w + 1];
    t[9] = 0;
  }
  Fr::E r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = t[w];
  r = Fr::reduce_once(r);
  if (T >= 6) r = Fr::reduce_once(r);
  if (T >= 11) r = Fr::reduce_once(r);
  return r;
}

// The same sum as t products, each reduced, then added: the measured
// alternative to sum_of_products (variant bit 2).
template <int T, class F, bool SMEM>
__device__ __forceinline__ Fr::E dot_products(const uint4* k,
                                              const Fr::E (&s)[T]) {
  Fr::E acc = F::mul(load_const<SMEM>(k), s[0]);
#pragma unroll
  for (int j = 1; j < T; ++j)
    acc = F::add(acc, F::mul(load_const<SMEM>(k + 2 * j), s[j]));
  return acc;
}

// A matrix row times the state: `k` points at the row's T constants.
template <int T, class F, bool SMEM, bool SUMS>
__device__ __forceinline__ Fr::E row_times(const uint4* k,
                                           const Fr::E (&s)[T]) {
  if constexpr (SUMS)
    return sum_of_products<T, SMEM>(reinterpret_cast<const uint32_t*>(k), s);
  else
    return dot_products<T, F, SMEM>(k, s);
}

template <class F>
__device__ __forceinline__ Fr::E sbox(const Fr::E& x) {
  const Fr::E x2 = F::mul(x, x);
  const Fr::E x4 = F::mul(x2, x2);
  return F::mul(x4, x);
}

// A full round: the S-box on every element, the constants `ark` (t values,
// none in the last round), then s <- mat * s.
template <int T, class F, bool SMEM, bool SUMS>
__device__ __forceinline__ void full_round(Fr::E (&s)[T],
                                           const uint4* ark,
                                           const uint4* mat) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    s[i] = sbox<F>(s[i]);
    if (ark != nullptr) s[i] = F::add(s[i], load_const<SMEM>(ark + 2 * i));
  }
  Fr::E o[T];
#pragma unroll
  for (int i = 0; i < T; ++i) o[i] = Fr::zero();
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    const Fr::E acc = row_times<T, F, SMEM, SUMS>(mat + 2 * T * i, s);
#pragma unroll
    for (int k = 0; k + 1 < T; ++k) o[k] = o[k + 1];
    o[T - 1] = acc;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = o[i];
}

// A partial round: s0 <- sbox(s0) + k, then the sparse mix of `sp` (the
// first row, t values, then the first column below the diagonal, t - 1).
template <int T, class F, bool SMEM, bool SUMS>
__device__ __forceinline__ void partial_round(Fr::E (&s)[T], const uint4* k,
                                              const uint4* sp) {
  s[0] = F::add(sbox<F>(s[0]), load_const<SMEM>(k));
  const Fr::E first = row_times<T, F, SMEM, SUMS>(sp, s);
#pragma unroll
  for (int j = 1; j < T; ++j)
    s[j] = F::add(s[j], F::mul(load_const<SMEM>(sp + 2 * (T + j - 1)), s[0]));
  s[0] = first;
}

// Table sizes in 16-byte units (two a constant): C, then M and P, then S.
__host__ __device__ constexpr int c_units(int t, int rp) {
  return 2 * (kFullRounds * t + rp);
}
__host__ __device__ constexpr int m_units(int t) { return 2 * t * t; }
__host__ __device__ constexpr int s_units(int t, int rp) {
  return 2 * rp * (2 * t - 1);
}

template <int T, class F, bool SMEM, bool SUMS>
__global__ void __launch_bounds__(kPermBlock, 1)
poseidon_perm_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, const uint4* __restrict__ c,
                     const uint4* __restrict__ m, const uint4* __restrict__ p,
                     const uint4* __restrict__ sp, int rp, int B) {
  extern __shared__ uint4 tables[];
  if (SMEM) {  // stage C, M, P, S once per block
    const int nc = c_units(T, rp), nm = m_units(T), ns = s_units(T, rp);
    for (int i = threadIdx.x; i < nc + 2 * nm + ns; i += blockDim.x)
      tables[i] = i < nc            ? c[i]
                  : i < nc + nm     ? m[i - nc]
                  : i < nc + 2 * nm ? p[i - nc - nm]
                                    : sp[i - nc - 2 * nm];
    __syncthreads();
    c = tables;
    m = c + nc;
    p = m + nm;
    sp = p + nm;
  }
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Fr::E s[T];
#pragma unroll
  for (int i = 0; i < T; ++i)
    s[i] = F::add(Fr::load(in + (size_t)i * 8 * B + b, B),
                  load_const<SMEM>(c + 2 * i));
#pragma unroll 1
  for (int r = 0; r < kFullRounds; ++r) {
    // round r's constants follow the initial t, and after the fourth
    // round the R_P partial-round constants
    const uint4* ark = r + 1 == kFullRounds
                           ? nullptr
                           : c + 2 * (T * (r + 1) + (r >= kHalf ? rp : 0));
    full_round<T, F, SMEM, SUMS>(s, ark, r + 1 == kHalf ? p : m);
    if (r + 1 == kHalf) {
      const uint4* k = c + 2 * T * (kHalf + 1);
#pragma unroll 1
      for (int j = 0; j < rp; ++j)
        partial_round<T, F, SMEM, SUMS>(s, k + 2 * j,
                                        sp + 2 * (2 * T - 1) * j);
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) Fr::store(out + (size_t)i * 8 * B + b, B, s[i]);
}

template <int T, class F, bool SMEM, bool SUMS = true>
int launch_perm(const void* in, void* out, const void* c, const void* m,
                const void* p, const void* sp, int rp, int B, void* stream) {
  const auto kernel = poseidon_perm_kernel<T, F, SMEM, SUMS>;
  const size_t smem =
      SMEM ? 16 * (size_t)(c_units(T, rp) + 2 * m_units(T) + s_units(T, rp))
           : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((B + kPermBlock - 1) / kPermBlock);
  kernel<<<grid, kPermBlock, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint4*)c, (const uint4*)m,
      (const uint4*)p, (const uint4*)sp, rp, B);
  return (int)cudaGetLastError();
}

}  // namespace inf

// in, out: (t, 8, B) words; c: (8t + rp, 8), m and p: (t, t, 8), sp:
// (rp, 2t - 1, 8) words, all Montgomery form (hash/poseidon.py `tables`).
// Returns cudaErrorInvalidValue for a width outside 2..13.
extern "C" int inf_poseidon_perm(const void* in, void* out, const void* c,
                                 const void* m, const void* p, const void* sp,
                                 int t, int rp, int B, void* stream) {
  using inf::PermField;
  using inf::kPermSmem;
  switch (t) {
#define INF_PERM_CASE(T)                                               \
  case T:                                                              \
    return inf::launch_perm<T, PermField, kPermSmem>(in, out, c, m, p, sp, \
                                                     rp, B, stream);
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

// The variants at t = 6, for measurement: bit 0 of `variant` puts the
// product out of line, bit 1 stages the tables in shared memory, bit 2
// (with bits 0 and 1 set) sums each matrix row as t reduced products.
extern "C" int inf_poseidon_perm_variant(const void* in, void* out,
                                         const void* c, const void* m,
                                         const void* p, const void* sp, int t,
                                         int rp, int B, int variant,
                                         void* stream) {
  if (t != 6) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return inf::launch_perm<6, inf::Fr, false>(in, out, c, m, p, sp, rp, B,
                                                 stream);
    case 1:
      return inf::launch_perm<6, inf::FrOutOfLine, false>(in, out, c, m, p,
                                                          sp, rp, B, stream);
    case 2:
      return inf::launch_perm<6, inf::Fr, true>(in, out, c, m, p, sp, rp, B,
                                                stream);
    case 3:
      return inf::launch_perm<6, inf::FrOutOfLine, true>(in, out, c, m, p,
                                                         sp, rp, B, stream);
    case 7:
      return inf::launch_perm<6, inf::FrOutOfLine, true, false>(
          in, out, c, m, p, sp, rp, B, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The main instance's variant, as `variant` numbers it above.
extern "C" int inf_poseidon_perm_main_variant() {
  return (std::is_same<inf::PermField, inf::FrOutOfLine>::value ? 1 : 0) |
         (inf::kPermSmem ? 2 : 0);
}
