// Copied from native/src/bn254.h, with Fq's sums and products on q's words
// as constants (`fq_*`) in place of the Mont context's.
// BN254 (alt_bn128) curve layer: Fq/Fr contexts, Fq2, G1/G2 affine and
// Jacobian ops — the native engine behind arkworks-format deserialization
// and the Groth16 verifier (reference contract: pallet/src/lib.rs:784-827
// via ark-bn254 0.4).
#pragma once

#include <optional>
#include <utility>

#include "u256.h"

namespace inf {

// Base and scalar field moduli.
inline const char* FQ_HEX =
    "30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47";
inline const char* FR_HEX =
    "30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001";

inline const Mont& FQ() {
  static Mont m = [] {
    Mont x;
    x.init(from_hex(FQ_HEX));
    return x;
  }();
  return m;
}

inline const Mont& FR() {
  static Mont m = [] {
    Mont x;
    x.init(from_hex(FR_HEX));
    return x;
  }();
  return m;
}

// ---- Fq, with q's words as constants --------------------------------------
//
// Sums and products of Fq in the Mont context's form (R = 2^256, values
// below q), with q's words as constants, the loops unrolled and inlined, and
// nothing branching on the data; a product takes about 0.6 of FQ().mul's time
// (x86-64, -O2). FQ() stays for conversions and the inverse. q < 2^254, so a
// sum of two values below q carries out of no word; and `fq_mul` takes
// factors below 2q (then a b + m q < 2q 2^256, which its one last
// subtraction brings below q), so a sum that only feeds a product is left
// unreduced (`fq_add_nr`).

constexpr u64 Q0 = 0x3c208c16d87cfd47ULL, Q1 = 0x97816a916871ca8dULL,
              Q2 = 0xb85045b68181585dULL, Q3 = 0x30644e72e131a029ULL;
constexpr u64 Q_NINV = 0x87d20782e4866389ULL;  // -q^-1 mod 2^64

[[gnu::always_inline]] inline U256 fq_add_nr(const U256& a, const U256& b) {
  U256 s;
  addc(s, a, b);
  return s;
}

// borrow of the word difference d = x - y - borrow, as 0 or 1
inline u64 borrow_of(u128 d) { return (u64)(d >> 127); }

// t - q where t >= q, else t: t < 2q
[[gnu::always_inline]] inline U256 fq_reduce_once(u64 t0, u64 t1, u64 t2,
                                                  u64 t3) {
  u128 d = (u128)t0 - Q0;
  u64 r0 = (u64)d;
  d = (u128)t1 - Q1 - borrow_of(d);
  u64 r1 = (u64)d;
  d = (u128)t2 - Q2 - borrow_of(d);
  u64 r2 = (u64)d;
  d = (u128)t3 - Q3 - borrow_of(d);
  u64 r3 = (u64)d;
  u64 keep = 0 - borrow_of(d);  // all ones where t is below q
  return {{(t0 & keep) | (r0 & ~keep), (t1 & keep) | (r1 & ~keep),
           (t2 & keep) | (r2 & ~keep), (t3 & keep) | (r3 & ~keep)}};
}

[[gnu::always_inline]] inline U256 fq_add(const U256& a, const U256& b) {
  u128 c = (u128)a.v[0] + b.v[0];
  u64 s0 = (u64)c;
  c = (u128)a.v[1] + b.v[1] + (u64)(c >> 64);
  u64 s1 = (u64)c;
  c = (u128)a.v[2] + b.v[2] + (u64)(c >> 64);
  u64 s2 = (u64)c;
  return fq_reduce_once(s0, s1, s2, a.v[3] + b.v[3] + (u64)(c >> 64));
}

[[gnu::always_inline]] inline U256 fq_sub(const U256& a, const U256& b) {
  u128 d = (u128)a.v[0] - b.v[0];
  u64 r0 = (u64)d;
  d = (u128)a.v[1] - b.v[1] - borrow_of(d);
  u64 r1 = (u64)d;
  d = (u128)a.v[2] - b.v[2] - borrow_of(d);
  u64 r2 = (u64)d;
  d = (u128)a.v[3] - b.v[3] - borrow_of(d);
  u64 r3 = (u64)d;
  u64 wrap = 0 - borrow_of(d);  // all ones where a < b: add q back
  u128 c = (u128)r0 + (Q0 & wrap);
  r0 = (u64)c;
  c = (u128)r1 + (Q1 & wrap) + (u64)(c >> 64);
  r1 = (u64)c;
  c = (u128)r2 + (Q2 & wrap) + (u64)(c >> 64);
  r2 = (u64)c;
  r3 = r3 + (Q3 & wrap) + (u64)(c >> 64);
  return {{r0, r1, r2, r3}};
}

[[gnu::always_inline]] inline U256 fq_neg(const U256& a) {
  return fq_sub(U256{}, a);
}

// a b / 2^256 mod q (CIOS), a and b below 2q.
[[gnu::always_inline]] inline U256 fq_mul(const U256& a, const U256& b) {
  u64 t0 = 0, t1 = 0, t2 = 0, t3 = 0;
#pragma GCC unroll 4
  for (int i = 0; i < 4; ++i) {
    u64 bi = b.v[i];
    u128 c = (u128)a.v[0] * bi + t0;
    t0 = (u64)c;
    c = (u128)a.v[1] * bi + t1 + (u64)(c >> 64);
    t1 = (u64)c;
    c = (u128)a.v[2] * bi + t2 + (u64)(c >> 64);
    t2 = (u64)c;
    c = (u128)a.v[3] * bi + t3 + (u64)(c >> 64);
    t3 = (u64)c;
    u64 t4 = (u64)(c >> 64);
    u64 m = t0 * Q_NINV;  // t + m q is divisible by 2^64
    c = (u128)m * Q0 + t0;
    c = (u128)m * Q1 + t1 + (u64)(c >> 64);
    t0 = (u64)c;
    c = (u128)m * Q2 + t2 + (u64)(c >> 64);
    t1 = (u64)c;
    c = (u128)m * Q3 + t3 + (u64)(c >> 64);
    t2 = (u64)c;
    t3 = t4 + (u64)(c >> 64);  // t stays below 3q < 2^256
  }
  return fq_reduce_once(t0, t1, t2, t3);
}

[[gnu::always_inline]] inline U256 fq_sqr(const U256& a) {
  return fq_mul(a, a);
}

// A product before its reduction: below q^2, or a few times q^2.
struct Wide {
  u64 v[8];
};

[[gnu::always_inline]] inline Wide wide_mul(const U256& a, const U256& b) {
  Wide r{};
#pragma GCC unroll 4
  for (int i = 0; i < 4; ++i) {
    u64 c = 0;
#pragma GCC unroll 4
    for (int j = 0; j < 4; ++j) {
      u128 t = (u128)a.v[j] * b.v[i] + r.v[i + j] + c;
      r.v[i + j] = (u64)t;
      c = (u64)(t >> 64);
    }
    r.v[i + 4] = c;
  }
  return r;
}

[[gnu::always_inline]] inline Wide wide_add(const Wide& a, const Wide& b) {
  Wide r;
  u64 c = 0;
#pragma GCC unroll 8
  for (int i = 0; i < 8; ++i) {
    u128 t = (u128)a.v[i] + b.v[i] + c;
    r.v[i] = (u64)t;
    c = (u64)(t >> 64);
  }
  return r;
}

[[gnu::always_inline]] inline Wide wide_sub(const Wide& a, const Wide& b) {
  Wide r;
  u64 borrow = 0;
#pragma GCC unroll 8
  for (int i = 0; i < 8; ++i) {
    u128 t = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)t;
    borrow = borrow_of(t);
  }
  return r;
}

// t / 2^256 mod q (Montgomery reduction), t below q 2^256.
[[gnu::always_inline]] inline U256 redc(Wide t) {
  constexpr u64 Q[4] = {Q0, Q1, Q2, Q3};
  u64 hi = 0;
#pragma GCC unroll 4
  for (int i = 0; i < 4; ++i) {
    u64 m = t.v[i] * Q_NINV, c = 0;
#pragma GCC unroll 4
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)m * Q[j] + t.v[i + j] + c;
      t.v[i + j] = (u64)s;
      c = (u64)(s >> 64);
    }
    u128 s = (u128)t.v[i + 4] + c + hi;
    t.v[i + 4] = (u64)s;
    hi = (u64)(s >> 64);
  }
  return fq_reduce_once(t.v[4], t.v[5], t.v[6], t.v[7]);  // t / 2^256 < 2q
}

// ---- Fq2 = Fq[u] / (u^2 + 1), elements in Montgomery form ----------------

struct Fq2 {
  U256 c0, c1;
  bool operator==(const Fq2& o) const { return c0 == o.c0 && c1 == o.c1; }
  bool is_zero() const { return c0.is_zero() && c1.is_zero(); }
};

inline Fq2 fq2_add(const Fq2& a, const Fq2& b) {
  return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
}
inline Fq2 fq2_sub(const Fq2& a, const Fq2& b) {
  return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
}
inline Fq2 fq2_neg(const Fq2& a) { return {fq_neg(a.c0), fq_neg(a.c1)}; }
// Karatsuba with one reduction for each half: a0 b0 - a1 b1 + q^2 and
// (a0 + a1)(b0 + b1) - a0 b0 - a1 b1 = a0 b1 + a1 b0 are both below 2q^2.
inline Fq2 fq2_mul(const Fq2& a, const Fq2& b) {
  static const Wide QQ = wide_mul({{Q0, Q1, Q2, Q3}}, {{Q0, Q1, Q2, Q3}});
  Wide p0 = wide_mul(a.c0, b.c0), p1 = wide_mul(a.c1, b.c1);
  Wide p2 = wide_mul(fq_add_nr(a.c0, a.c1), fq_add_nr(b.c0, b.c1));
  return {redc(wide_sub(wide_add(p0, QQ), p1)),
          redc(wide_sub(p2, wide_add(p0, p1)))};
}
// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 products.
inline Fq2 fq2_sqr(const Fq2& a) {
  U256 t = fq_mul(a.c0, a.c1);
  return {fq_mul(fq_add_nr(a.c0, a.c1), fq_sub(a.c0, a.c1)), fq_add(t, t)};
}
inline Fq2 fq2_inv(const Fq2& a) {
  U256 ni = FQ().inv(fq_add(fq_sqr(a.c0), fq_sqr(a.c1)));
  return {fq_mul(a.c0, ni), fq_neg(fq_mul(a.c1, ni))};
}

// ---- generic short-Weierstrass group over a field Ops --------------------

struct FqOps {
  using T = U256;
  static T add(const T& a, const T& b) { return fq_add(a, b); }
  static T sub(const T& a, const T& b) { return fq_sub(a, b); }
  static T neg(const T& a) { return fq_neg(a); }
  static T mul(const T& a, const T& b) { return fq_mul(a, b); }
  static T sqr(const T& a) { return fq_sqr(a); }
  static T inv(const T& a) { return FQ().inv(a); }
  static bool is_zero(const T& a) { return a.is_zero(); }
  static T zero() { return U256{}; }
  static T one() { return FQ().one_m; }
};

struct Fq2Ops {
  using T = Fq2;
  static T add(const T& a, const T& b) { return fq2_add(a, b); }
  static T sub(const T& a, const T& b) { return fq2_sub(a, b); }
  static T neg(const T& a) { return fq2_neg(a); }
  static T mul(const T& a, const T& b) { return fq2_mul(a, b); }
  static T sqr(const T& a) { return fq2_sqr(a); }
  static T inv(const T& a) { return fq2_inv(a); }
  static bool is_zero(const T& a) { return a.is_zero(); }
  static T zero() { return {U256{}, U256{}}; }
  static T one() { return {FQ().one_m, U256{}}; }
};

// Affine point; infinity flagged separately.
template <typename Ops>
struct Affine {
  typename Ops::T x, y;
  bool inf = true;
};

// Jacobian point (z == 0 means infinity).
template <typename Ops>
struct Jac {
  typename Ops::T x, y, z;
};

template <typename Ops>
Jac<Ops> jac_from_affine(const Affine<Ops>& p) {
  if (p.inf) return {Ops::one(), Ops::one(), Ops::zero()};
  return {p.x, p.y, Ops::one()};
}

template <typename Ops>
Affine<Ops> jac_to_affine(const Jac<Ops>& p) {
  if (Ops::is_zero(p.z)) return {};
  auto zi = Ops::inv(p.z);
  auto zi2 = Ops::sqr(zi);
  Affine<Ops> r;
  r.x = Ops::mul(p.x, zi2);
  r.y = Ops::mul(p.y, Ops::mul(zi2, zi));
  r.inf = false;
  return r;
}

template <typename Ops>
Jac<Ops> jac_double(const Jac<Ops>& p) {
  if (Ops::is_zero(p.z)) return p;
  auto a = Ops::sqr(p.x);
  auto b = Ops::sqr(p.y);
  auto c = Ops::sqr(b);
  auto t = Ops::sub(Ops::sqr(Ops::add(p.x, b)), Ops::add(a, c));
  auto d = Ops::add(t, t);
  auto e = Ops::add(Ops::add(a, a), a);
  auto f = Ops::sqr(e);
  auto c8 = Ops::add(Ops::add(c, c), Ops::add(c, c));
  c8 = Ops::add(c8, c8);
  Jac<Ops> r;
  r.x = Ops::sub(f, Ops::add(d, d));
  r.y = Ops::sub(Ops::mul(e, Ops::sub(d, r.x)), c8);
  auto yz = Ops::mul(p.y, p.z);
  r.z = Ops::add(yz, yz);
  return r;
}

template <typename Ops>
Jac<Ops> jac_add(const Jac<Ops>& p, const Jac<Ops>& q) {
  if (Ops::is_zero(p.z)) return q;
  if (Ops::is_zero(q.z)) return p;
  auto z1z1 = Ops::sqr(p.z);
  auto z2z2 = Ops::sqr(q.z);
  auto u1 = Ops::mul(p.x, z2z2);
  auto u2 = Ops::mul(q.x, z1z1);
  auto s1 = Ops::mul(Ops::mul(p.y, q.z), z2z2);
  auto s2 = Ops::mul(Ops::mul(q.y, p.z), z1z1);
  if (u1 == u2) {
    if (s1 == s2) return jac_double(p);
    return {Ops::one(), Ops::one(), Ops::zero()};
  }
  auto h = Ops::sub(u2, u1);
  auto i = Ops::add(h, h);
  i = Ops::sqr(i);
  auto j = Ops::mul(h, i);
  auto rr = Ops::sub(s2, s1);
  rr = Ops::add(rr, rr);
  auto v = Ops::mul(u1, i);
  Jac<Ops> r;
  r.x = Ops::sub(Ops::sub(Ops::sqr(rr), j), Ops::add(v, v));
  auto sj = Ops::mul(s1, j);
  r.y = Ops::sub(Ops::mul(rr, Ops::sub(v, r.x)), Ops::add(sj, sj));
  r.z = Ops::mul(
      Ops::sub(Ops::sqr(Ops::add(p.z, q.z)), Ops::add(z1z1, z2z2)), h);
  return r;
}

template <typename Ops>
Jac<Ops> jac_mul(const Jac<Ops>& p, const U256& k) {
  Jac<Ops> acc{Ops::one(), Ops::one(), Ops::zero()};
  int n = k.bit_length();
  for (int i = n - 1; i >= 0; --i) {
    acc = jac_double(acc);
    if (k.bit(i)) acc = jac_add(acc, p);
  }
  return acc;
}

using G1 = Affine<FqOps>;
using G2 = Affine<Fq2Ops>;

// curve coefficients (Montgomery form): b1 = 3, b2 = 3/(9+u)
inline U256 B1() { return FQ().to_mont(U256{{3, 0, 0, 0}}); }
inline Fq2 B2() {
  static Fq2 b = [] {
    // 19485874751759354771024239261021720505790618469301721065564631296452457478373
    // 266929791119991161246907387137283842545076965332900288569378510910307636690
    Fq2 r;
    r.c0 = FQ().to_mont(from_hex(
        "2b149d40ceb8aaae81be18991be06ac3b5b4c5e559dbefa33267e6dc24a138e5"));
    r.c1 = FQ().to_mont(from_hex(
        "009713b03af0fed4cd2cafadeed8fdf4a74fa084e52d1852e4a2bd0685c315d2"));
    return r;
  }();
  return b;
}

inline bool g1_on_curve(const G1& p) {
  if (p.inf) return true;
  return fq_sqr(p.y) == fq_add(fq_mul(fq_sqr(p.x), p.x), B1());
}

inline bool g2_on_curve(const G2& p) {
  if (p.inf) return true;
  Fq2 lhs = fq2_sqr(p.y);
  Fq2 rhs = fq2_add(fq2_mul(fq2_sqr(p.x), p.x), B2());
  return lhs == rhs;
}

inline bool g2_in_subgroup(const G2& p) {
  if (p.inf) return true;
  auto r = jac_mul(jac_from_affine<Fq2Ops>(p), from_hex(FR_HEX));
  return Fq2Ops::is_zero(r.z);
}

}  // namespace inf
