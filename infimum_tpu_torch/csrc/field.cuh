// BN254 prime-field (Fq, Fr) and Fq2 arithmetic and the RCB complete
// addition formulas, as __device__ code for the MSM kernels (msm_accum.cu,
// msm_weighted.cu, msm_layout.cu), the fixed-base multiply
// (fixed_base.cu), the cross-rank sum (point_sum.cu) and the Fr kernels
// (poseidon_perm.cu, fr_ntt.cu, fr_rows.cu). The fixed-base multiply alone
// runs over a second Montgomery product of two carry chains
// (`two_chains::mul`, FqTwoChains, Fq2TwoChains).
//
// Replaces the in-kernel helpers of infimum_tpu/msm/pallas_field.py (Fq,
// Fq2, rcb_add, rcb_add_mixed) and infimum_tpu/ff/pallas_fp.py (Fr). A
// field element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256: the same integer as the reference's 16 x 16-bit limbs, so word
// i = limb 2i | limb 2i+1 << 16. Multiplication is CIOS Montgomery over
// 32-bit words with PTX carry chains; the TPU's 16-bit limbs and exact-f32
// column tricks are not needed on this card. Fp<Params> is generic over the
// modulus: Fq = Fp<FqParams>, Fr = Fp<FrParams>. An Fq2 element is
// (c0, c1) with u^2 = -1, words c0[0..7] then c1[0..7]. Every function is
// inline and straight-line over registers, but for the out-of-line
// products of FqOutOfLine, FrOutOfLine and Fq2OutOfLine.
//
// The constants below are checked against the Python values by
// tests/test_torch_msm.py (test_field_header_constants).
#pragma once

#include <cstdint>

namespace inf {

// p = 21888242871839275222246405745257275088696311157297823662689037894645226208583
#define INF_FQ_P {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, \
                  0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}
// -p^-1 mod 2^32
#define INF_FQ_INV 0xe4866389u
// R mod p (1 in Montgomery form)
#define INF_FQ_ONE {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, \
                    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}
// 3 * b2 for G2 (b2 = 3 / (9 + u)), each component in Montgomery form
#define INF_G2_B3_C0 {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u, \
                      0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u}
#define INF_G2_B3_C1 {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u, \
                      0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au}
// r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
#define INF_FR_P {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, \
                  0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}
// -r^-1 mod 2^32
#define INF_FR_INV 0xefffffffu
// R mod r (1 in Montgomery form)
#define INF_FR_ONE {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, \
                    0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}

// PTX carry-chain steps for the Montgomery product. Each is one
// instruction; the carry flag flows from one asm statement to the next,
// which nvcc keeps in order (volatile) and emits nothing between that
// touches the flag.
namespace ptx {
#define INF_PTX3(name, op)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,        \
                                           uint32_t c) {                  \
    uint32_t r;                                                           \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                             \
  }
#define INF_PTX2(name, op)                                        \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) { \
    uint32_t r;                                                   \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));   \
    return r;                                                     \
  }
INF_PTX3(mad_lo_cc, "mad.lo.cc.u32")
INF_PTX3(madc_lo_cc, "madc.lo.cc.u32")
INF_PTX3(mad_hi_cc, "mad.hi.cc.u32")
INF_PTX3(madc_hi_cc, "madc.hi.cc.u32")
INF_PTX3(madc_hi, "madc.hi.u32")
INF_PTX2(addc, "addc.u32")
INF_PTX2(addc_cc, "addc.cc.u32")
INF_PTX2(sub_cc, "sub.cc.u32")
INF_PTX2(subc_cc, "subc.cc.u32")
INF_PTX2(subc, "subc.u32")
#undef INF_PTX3
#undef INF_PTX2
}  // namespace ptx

// A modulus as the device code reads it: word i of the modulus and of
// R mod modulus (constant once the word loops unroll), and -modulus^-1
// mod 2^32. Both moduli are below 2^254.
struct FqParams {
  static constexpr uint32_t INV = INF_FQ_INV;
  static __device__ __forceinline__ uint32_t p(int i) {
    constexpr uint32_t P[8] = INF_FQ_P;
    return P[i];
  }
  static __device__ __forceinline__ uint32_t one(int i) {
    constexpr uint32_t ONE[8] = INF_FQ_ONE;
    return ONE[i];
  }
};

struct FrParams {
  static constexpr uint32_t INV = INF_FR_INV;
  static __device__ __forceinline__ uint32_t p(int i) {
    constexpr uint32_t P[8] = INF_FR_P;
    return P[i];
  }
  static __device__ __forceinline__ uint32_t one(int i) {
    constexpr uint32_t ONE[8] = INF_FR_ONE;
    return ONE[i];
  }
};

template <class Params>
struct Fp {
  static constexpr int WORDS = 8;
  struct E {
    uint32_t w[8];
  };

  static __device__ __forceinline__ E zero() {
    E r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = 0;
    return r;
  }

  static __device__ __forceinline__ E one() {
    E r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = Params::one(i);
    return r;
  }

  static __device__ __forceinline__ E constant(const uint32_t (&k)[8]) {
    E r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = k[i];
    return r;
  }

  // r - p when r >= p, else r (r < 2p)
  static __device__ __forceinline__ E reduce_once(const E& r) {
    E d;
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint64_t v = (uint64_t)r.w[i] - Params::p(i) - br;
      d.w[i] = (uint32_t)v;
      br = (uint32_t)(v >> 63);
    }
    return br ? r : d;
  }

  static __device__ __forceinline__ E add(const E& a, const E& b) {
    E s;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c += (uint64_t)a.w[i] + b.w[i];
      s.w[i] = (uint32_t)c;
      c >>= 32;
    }
    return reduce_once(s);  // a + b < 2p < 2^255: no carry out
  }

  static __device__ __forceinline__ E sub(const E& a, const E& b) {
    E d;
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint64_t v = (uint64_t)a.w[i] - b.w[i] - br;
      d.w[i] = (uint32_t)v;
      br = (uint32_t)(v >> 63);
    }
    if (br) {
      uint64_t c = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c += (uint64_t)d.w[i] + Params::p(i);
        d.w[i] = (uint32_t)c;
        c >>= 32;
      }
    }
    return d;
  }

  static __device__ __forceinline__ E neg(const E& a) { return sub(zero(), a); }

  // CIOS Montgomery product a * b * 2^-256 mod p, each row's low and high
  // halves added with PTX carry chains (mad.lo.cc / madc.hi.cc): the
  // carries ride the hardware carry flag instead of 64-bit accumulators.
  // t < 2p before each row, so t + a * b_i + m * p < 2^288: 9 words hold
  // every row and nothing carries out of t[8].
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    uint32_t t[9];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = a.w[j] * b.w[0];
    t[8] = __umulhi(a.w[7], b.w[0]);
    t[1] = ptx::mad_hi_cc(a.w[0], b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      t[j + 1] = ptx::madc_hi_cc(a.w[j], b.w[0], t[j + 1]);
    t[8] = ptx::addc(t[8], 0);
    reduce_row(t);
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      t[0] = ptx::mad_lo_cc(a.w[0], b.w[i], t[0]);
#pragma unroll
      for (int j = 1; j < 8; ++j) t[j] = ptx::madc_lo_cc(a.w[j], b.w[i], t[j]);
      t[8] = ptx::addc(t[8], 0);
      t[1] = ptx::mad_hi_cc(a.w[0], b.w[i], t[1]);
#pragma unroll
      for (int j = 1; j < 7; ++j)
        t[j + 1] = ptx::madc_hi_cc(a.w[j], b.w[i], t[j + 1]);
      t[8] = ptx::madc_hi(a.w[7], b.w[i], t[8]);
      reduce_row(t);
    }
    E d, r;  // t < 2p: subtract p once where t >= p
    d.w[0] = ptx::sub_cc(t[0], Params::p(0));
#pragma unroll
    for (int j = 1; j < 8; ++j) d.w[j] = ptx::subc_cc(t[j], Params::p(j));
    const uint32_t borrow = ptx::subc(0, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = borrow ? t[j] : d.w[j];
    return r;
  }

  // t += m * p with m = -t[0] / p mod 2^32, then t >>= 32 (t[0] is then 0)
  static __device__ __forceinline__ void reduce_row(uint32_t (&t)[9]) {
    const uint32_t m = t[0] * Params::INV;
    ptx::mad_lo_cc(m, Params::p(0), t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = ptx::madc_lo_cc(m, Params::p(j), t[j]);
    t[8] = ptx::addc(t[8], 0);
    t[1] = ptx::mad_hi_cc(m, Params::p(0), t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      t[j + 1] = ptx::madc_hi_cc(m, Params::p(j), t[j + 1]);
    t[8] = ptx::madc_hi(m, Params::p(7), t[8]);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }

  // 9x = 3b * x for G1 (b = 3), over Fq: three doublings and an add
  static __device__ __forceinline__ E b3(const E& x) {
    const E x2 = add(x, x);
    const E x4 = add(x2, x2);
    const E x8 = add(x4, x4);
    return add(x8, x);
  }

  static __device__ __forceinline__ E load(const uint32_t* p, size_t stride) {
    E r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = p[i * stride];
    return r;
  }

  static __device__ __forceinline__ void store(uint32_t* p, size_t stride,
                                               const E& a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i * stride] = a.w[i];
  }
};

using Fq = Fp<FqParams>;
using Fr = Fp<FrParams>;

// Fq with its product out of line, the field of the G1 accumulation: one
// copy of the product's code instead of 11 inlined in each mixed add
// (about 100 KB of SASS, more than the instruction cache holds). The
// operands go by value, in registers: by reference they went through a
// 352-byte stack frame and the kernel ran slower (PERF.md, section 6).
struct FqOutOfLine : Fq {
  static __device__ __noinline__ E mul(E a, E b) { return Fq::mul(a, b); }
};

// Fr with its product out of line, the Poseidon kernel's product for its
// S-boxes and columns (poseidon_perm.cu): one copy of the product's code,
// called from every round, where inlined the kernel ran slower (PERF.md,
// section 6).
struct FrOutOfLine : Fr {
  static __device__ __noinline__ E mul(E a, E b) { return Fr::mul(a, b); }
};

struct Fq2 {
  static constexpr int WORDS = 16;
  struct E {
    Fq::E c0, c1;
  };

  static __device__ __forceinline__ E zero() { return {Fq::zero(), Fq::zero()}; }
  static __device__ __forceinline__ E one() { return {Fq::one(), Fq::zero()}; }

  static __device__ __forceinline__ E add(const E& a, const E& b) {
    return {Fq::add(a.c0, b.c0), Fq::add(a.c1, b.c1)};
  }

  static __device__ __forceinline__ E sub(const E& a, const E& b) {
    return {Fq::sub(a.c0, b.c0), Fq::sub(a.c1, b.c1)};
  }

  static __device__ __forceinline__ E neg(const E& a) {
    return {Fq::neg(a.c0), Fq::neg(a.c1)};
  }

  // Karatsuba: 3 Fq products
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    const Fq::E v0 = Fq::mul(a.c0, b.c0);
    const Fq::E v1 = Fq::mul(a.c1, b.c1);
    const Fq::E s = Fq::mul(Fq::add(a.c0, a.c1), Fq::add(b.c0, b.c1));
    return {Fq::sub(v0, v1), Fq::sub(Fq::sub(s, v0), v1)};
  }

  static __device__ __forceinline__ E load(const uint32_t* p, size_t stride) {
    return {Fq::load(p, stride), Fq::load(p + 8 * stride, stride)};
  }

  static __device__ __forceinline__ void store(uint32_t* p, size_t stride,
                                               const E& a) {
    Fq::store(p, stride, a.c0);
    Fq::store(p + 8 * stride, stride, a.c1);
  }
};

// Fq2 with its product out of line, the field of both G2 kernels (Fq2 has
// no b3 of its own). With the product inlined at its call sites a G2 add
// holds 255 registers and spills (--resource-usage), and a chain of
// complete adds ran at 1.9x the latency (87.2 against 46.4 us an add on an
// H100, PERF.md, section 6). By reference, unlike FqOutOfLine: by value
// the accumulation kernel spilled and ran no faster.
struct Fq2OutOfLine : Fq2 {
  static __device__ __noinline__ E mul(const E& a, const E& b) {
    return Fq2::mul(a, b);
  }

  // x * 3b2 (3b2 = k0 + k1 u) as one out-of-line product by the constant:
  // 3 Fq products
  static __device__ __forceinline__ E b3(const E& x) {
    constexpr uint32_t K0[8] = INF_G2_B3_C0;
    constexpr uint32_t K1[8] = INF_G2_B3_C1;
    return mul(x, {Fq::constant(K0), Fq::constant(K1)});
  }
};

// The Montgomery product a * b * 2^-256 mod p with two independent carry
// chains, the running sum kept as an aligned part E (words 0..8) and an
// offset part O (words 1..9): a row adds the even words' products a_j b_i
// (low half at word j, high at j + 1) into E and the odd words' into O,
// one chain each, and so does the reduction by m = E[0] (-p^-1) mod 2^32
// (E[0] is the sum's word 0: O has none). After the division by 2^32 the
// old O is the aligned part and the old E, two words down, the offset
// part; one add of the old E's word 1 into the old O's word 0 joins them,
// and its carry opens the next row's offset chain. The parts are added
// once at the end: t < 2p, then one conditional subtraction. Fp::mul's
// rows are one chain of 32 dependent steps; here two of 8 run side by
// side, twice a row. Same count of multiplies; the same value, below p,
// as Fp::mul for a, b < p.
namespace two_chains {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// E += m p_even, O += m p_odd with m = E[0] (-p^-1): E[0] becomes 0
template <class Params>
__device__ __forceinline__ void reduce(uint32_t (&e)[9], uint32_t (&o)[9]) {
  const uint32_t m = e[0] * Params::INV;
  o[0] = ptx::mad_lo_cc(m, Params::p(1), o[0]);
  o[1] = ptx::madc_hi_cc(m, Params::p(1), o[1]);
#pragma unroll
  for (int j = 3; j < 8; j += 2) {
    o[j - 1] = ptx::madc_lo_cc(m, Params::p(j), o[j - 1]);
    o[j] = ptx::madc_hi_cc(m, Params::p(j), o[j]);
  }
  o[8] = ptx::addc(o[8], 0);
  e[0] = ptx::mad_lo_cc(m, Params::p(0), e[0]);
  e[1] = ptx::madc_hi_cc(m, Params::p(0), e[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    e[j] = ptx::madc_lo_cc(m, Params::p(j), e[j]);
    e[j + 1] = ptx::madc_hi_cc(m, Params::p(j), e[j + 1]);
  }
  e[8] = ptx::addc(e[8], 0);
}

template <class Params>
__device__ __forceinline__ typename Fp<Params>::E mul(
    const typename Fp<Params>::E& a, const typename Fp<Params>::E& b) {
  uint32_t e[9], o[9];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    e[j] = a.w[j] * b.w[0];
    e[j + 1] = __umulhi(a.w[j], b.w[0]);
    o[j] = a.w[j + 1] * b.w[0];
    o[j + 1] = __umulhi(a.w[j + 1], b.w[0]);
  }
  e[8] = 0;
  o[8] = 0;
  reduce<Params>(e, o);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const uint32_t bi = b.w[i];
    uint32_t ne[9], no[9];
    ne[0] = add_cc(o[0], e[1]);
    no[0] = ptx::madc_lo_cc(a.w[1], bi, e[2]);
    no[1] = ptx::madc_hi_cc(a.w[1], bi, e[3]);
    no[2] = ptx::madc_lo_cc(a.w[3], bi, e[4]);
    no[3] = ptx::madc_hi_cc(a.w[3], bi, e[5]);
    no[4] = ptx::madc_lo_cc(a.w[5], bi, e[6]);
    no[5] = ptx::madc_hi_cc(a.w[5], bi, e[7]);
    no[6] = ptx::madc_lo_cc(a.w[7], bi, e[8]);
    no[7] = ptx::madc_hi_cc(a.w[7], bi, 0);
    no[8] = ptx::addc(0, 0);
    ne[0] = ptx::mad_lo_cc(a.w[0], bi, ne[0]);
    ne[1] = ptx::madc_hi_cc(a.w[0], bi, o[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      ne[j] = ptx::madc_lo_cc(a.w[j], bi, o[j]);
      ne[j + 1] = ptx::madc_hi_cc(a.w[j], bi, o[j + 1]);
    }
    ne[8] = ptx::addc(o[8], 0);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      e[j] = ne[j];
      o[j] = no[j];
    }
    reduce<Params>(e, o);
  }
  uint32_t t[8];
  t[0] = add_cc(e[1], o[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) t[k] = ptx::addc_cc(e[k + 1], o[k]);
  typename Fp<Params>::E d, r;  // t < 2p: subtract p once where t >= p
  d.w[0] = ptx::sub_cc(t[0], Params::p(0));
#pragma unroll
  for (int j = 1; j < 8; ++j) d.w[j] = ptx::subc_cc(t[j], Params::p(j));
  const uint32_t borrow = ptx::subc(0, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = borrow ? t[j] : d.w[j];
  return r;
}

}  // namespace two_chains

// Fq with the two-chain product out of line, by value as FqOutOfLine: the
// fixed-base multiply's G1 field and its epilogue's
struct FqTwoChains : Fq {
  static __device__ __noinline__ E mul(E a, E b) {
    return two_chains::mul<FqParams>(a, b);
  }
};

// Fq2 over the two-chain product (Karatsuba, 3 products), out of line by
// value: the fixed-base multiply's G2 field. By reference, as
// Fq2OutOfLine, the G2 fixed-base kernel kept an 832-936 byte stack frame
// and took 17-35% more time (PERF.md, section 6).
struct Fq2TwoChains : Fq2 {
  static __device__ __noinline__ E mul(E a, E b) {
    const Fq::E v0 = two_chains::mul<FqParams>(a.c0, b.c0);
    const Fq::E v1 = two_chains::mul<FqParams>(a.c1, b.c1);
    const Fq::E s = two_chains::mul<FqParams>(Fq::add(a.c0, a.c1),
                                              Fq::add(b.c0, b.c1));
    return {Fq::sub(v0, v1), Fq::sub(Fq::sub(s, v0), v1)};
  }

  static __device__ __forceinline__ E b3(const E& x) {
    constexpr uint32_t K0[8] = INF_G2_B3_C0;
    constexpr uint32_t K1[8] = INF_G2_B3_C1;
    return mul(x, {Fq::constant(K0), Fq::constant(K1)});
  }
};

template <class F>
struct Proj {
  typename F::E x, y, z;
};

template <class F>
struct Affine {
  typename F::E x, y;
};

// row `row` of a table of affine points, x then y, W words each, read as
// 16-byte vectors through the read-only cache
template <class F>
__device__ __forceinline__ Affine<F> load_row(const uint4* __restrict__ table,
                                              int32_t row) {
  constexpr int W = F::WORDS, V = 2 * W / 4;
  uint4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __ldg(table + (size_t)row * V + k);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(v);
  return {F::load(w, 1), F::load(w + W, 1)};
}

template <class F>
__device__ __forceinline__ Proj<F> proj_infinity() {
  return {F::zero(), F::one(), F::zero()};
}

// projective point as 3 * F::WORDS words, word k at p[k * stride]
template <class F>
__device__ __forceinline__ Proj<F> load_proj(const uint32_t* p, size_t stride) {
  constexpr int W = F::WORDS;
  return {F::load(p, stride), F::load(p + W * stride, stride),
          F::load(p + 2 * W * stride, stride)};
}

template <class F>
__device__ __forceinline__ void store_proj(uint32_t* p, size_t stride,
                                           const Proj<F>& a) {
  constexpr int W = F::WORDS;
  F::store(p, stride, a.x);
  F::store(p + W * stride, stride, a.y);
  F::store(p + 2 * W * stride, stride, a.z);
}

// Complete projective P + Q for a = 0 (Renes-Costello-Batina Alg. 7);
// covers P + P, P + (-P) and infinity on either side.
template <class F>
__device__ __forceinline__ Proj<F> rcb_add(const Proj<F>& p, const Proj<F>& q) {
  using E = typename F::E;
  E t0 = F::mul(p.x, q.x);
  E t1 = F::mul(p.y, q.y);
  E t2 = F::mul(p.z, q.z);
  E t3 = F::add(p.x, p.y);
  E t4 = F::add(q.x, q.y);
  t3 = F::mul(t3, t4);
  t4 = F::add(t0, t1);
  t3 = F::sub(t3, t4);
  t4 = F::add(p.y, p.z);
  E X3 = F::add(q.y, q.z);
  t4 = F::mul(t4, X3);
  X3 = F::add(t1, t2);
  t4 = F::sub(t4, X3);
  X3 = F::add(p.x, p.z);
  E Y3 = F::add(q.x, q.z);
  X3 = F::mul(X3, Y3);
  Y3 = F::add(t0, t2);
  Y3 = F::sub(X3, Y3);
  X3 = F::add(t0, t0);
  t0 = F::add(X3, t0);
  t2 = F::b3(t2);
  E Z3 = F::add(t1, t2);
  t1 = F::sub(t1, t2);
  Y3 = F::b3(Y3);
  X3 = F::mul(t4, Y3);
  t2 = F::mul(t3, t1);
  X3 = F::sub(t2, X3);
  Y3 = F::mul(Y3, t0);
  t1 = F::mul(t1, Z3);
  Y3 = F::add(t1, Y3);
  t0 = F::mul(t0, t3);
  Z3 = F::mul(Z3, t4);
  Z3 = F::add(Z3, t0);
  return {X3, Y3, Z3};
}

// Complete mixed P + (x2, y2) (Alg. 8): Q affine and never infinity.
template <class F>
__device__ __forceinline__ Proj<F> rcb_add_mixed(const Proj<F>& p,
                                                 const typename F::E& x2,
                                                 const typename F::E& y2) {
  using E = typename F::E;
  E t0 = F::mul(p.x, x2);
  E t1 = F::mul(p.y, y2);
  E t3 = F::add(x2, y2);
  E t4 = F::add(p.x, p.y);
  t3 = F::mul(t3, t4);
  t4 = F::add(t0, t1);
  t3 = F::sub(t3, t4);
  t4 = F::mul(y2, p.z);
  t4 = F::add(t4, p.y);
  E Y3 = F::mul(x2, p.z);
  Y3 = F::add(Y3, p.x);
  E X3 = F::add(t0, t0);
  t0 = F::add(X3, t0);
  E t2 = F::b3(p.z);
  E Z3 = F::add(t1, t2);
  t1 = F::sub(t1, t2);
  Y3 = F::b3(Y3);
  X3 = F::mul(t4, Y3);
  t2 = F::mul(t3, t1);
  X3 = F::sub(t2, X3);
  Y3 = F::mul(Y3, t0);
  t1 = F::mul(t1, Z3);
  Y3 = F::add(t1, Y3);
  t0 = F::mul(t0, t3);
  Z3 = F::mul(Z3, t4);
  Z3 = F::add(Z3, t0);
  return {X3, Y3, Z3};
}

}  // namespace inf
