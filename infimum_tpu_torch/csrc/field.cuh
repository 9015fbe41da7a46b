// BN254 Fq / Fq2 arithmetic and the RCB complete addition formulas, as
// __device__ code for the MSM kernels (msm_accum.cu, msm_weighted.cu).
//
// Replaces the in-kernel helpers of infimum_tpu/msm/pallas_field.py (Fq,
// Fq2, rcb_add, rcb_add_mixed). An Fq element is 8 little-endian 32-bit
// words in Montgomery form with R = 2^256: the same integer as the
// reference's 16 x 16-bit limbs, so word i = limb 2i | limb 2i+1 << 16.
// Multiplication is CIOS Montgomery with 32x32->64-bit products; the TPU's
// 16-bit limbs and exact-f32 column tricks are not needed on this card.
// An Fq2 element is (c0, c1) with u^2 = -1, words c0[0..7] then c1[0..7].
// Every function is inline and straight-line over registers.
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

struct Fq {
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
    constexpr uint32_t ONE[8] = INF_FQ_ONE;
    E r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = ONE[i];
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
    constexpr uint32_t P[8] = INF_FQ_P;
    E d;
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint64_t v = (uint64_t)r.w[i] - P[i] - br;
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
    constexpr uint32_t P[8] = INF_FQ_P;
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
        c += (uint64_t)d.w[i] + P[i];
        d.w[i] = (uint32_t)c;
        c >>= 32;
      }
    }
    return d;
  }

  static __device__ __forceinline__ E neg(const E& a) { return sub(zero(), a); }

  // CIOS Montgomery product a * b * 2^-256 mod p. Every 64-bit accumulator
  // step adds at most (2^32-1)^2 + 2(2^32-1) = 2^64-1, so nothing wraps.
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    constexpr uint32_t P[8] = INF_FQ_P;
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c += (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i];
        t[j] = (uint32_t)c;
        c >>= 32;
      }
      c += t[8];
      t[8] = (uint32_t)c;
      t[9] = (uint32_t)(c >> 32);
      const uint32_t m = t[0] * INF_FQ_INV;
      c = ((uint64_t)t[0] + (uint64_t)m * P[0]) >> 32;
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        c += (uint64_t)t[j] + (uint64_t)m * P[j];
        t[j - 1] = (uint32_t)c;
        c >>= 32;
      }
      c += t[8];
      t[7] = (uint32_t)c;
      t[8] = t[9] + (uint32_t)(c >> 32);
    }
    E r;  // t < 2p < 2^255 for a, b < p, so t[8] == 0
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = t[i];
    return reduce_once(r);
  }

  // 9x = 3b * x for G1 (b = 3): three doublings and an add
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

  // x * 3b2 with the constant 3b2 = k0 + k1 u: 4 Fq products
  static __device__ __forceinline__ E b3(const E& x) {
    constexpr uint32_t K0[8] = INF_G2_B3_C0;
    constexpr uint32_t K1[8] = INF_G2_B3_C1;
    const Fq::E k0 = Fq::constant(K0);
    const Fq::E k1 = Fq::constant(K1);
    return {Fq::sub(Fq::mul(x.c0, k0), Fq::mul(x.c1, k1)),
            Fq::add(Fq::mul(x.c0, k1), Fq::mul(x.c1, k0))};
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

template <class F>
struct Proj {
  typename F::E x, y, z;
};

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
