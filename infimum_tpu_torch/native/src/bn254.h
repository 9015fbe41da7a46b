// Copied from native/src/bn254.h.
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

// ---- Fq2 = Fq[u] / (u^2 + 1), elements in Montgomery form ----------------

struct Fq2 {
  U256 c0, c1;
  bool operator==(const Fq2& o) const { return c0 == o.c0 && c1 == o.c1; }
  bool is_zero() const { return c0.is_zero() && c1.is_zero(); }
};

inline Fq2 fq2_add(const Fq2& a, const Fq2& b) {
  return {FQ().add(a.c0, b.c0), FQ().add(a.c1, b.c1)};
}
inline Fq2 fq2_sub(const Fq2& a, const Fq2& b) {
  return {FQ().sub(a.c0, b.c0), FQ().sub(a.c1, b.c1)};
}
inline Fq2 fq2_neg(const Fq2& a) { return {FQ().neg(a.c0), FQ().neg(a.c1)}; }
inline Fq2 fq2_mul(const Fq2& a, const Fq2& b) {
  const Mont& F = FQ();
  U256 t0 = F.mul(a.c0, b.c0), t1 = F.mul(a.c1, b.c1);
  U256 t2 = F.mul(F.add(a.c0, a.c1), F.add(b.c0, b.c1));
  return {F.sub(t0, t1), F.sub(t2, F.add(t0, t1))};
}
inline Fq2 fq2_sqr(const Fq2& a) { return fq2_mul(a, a); }
inline Fq2 fq2_inv(const Fq2& a) {
  const Mont& F = FQ();
  U256 norm = F.add(F.sqr(a.c0), F.sqr(a.c1));
  U256 ni = F.inv(norm);
  return {F.mul(a.c0, ni), F.neg(F.mul(a.c1, ni))};
}

// ---- generic short-Weierstrass group over a field Ops --------------------

struct FqOps {
  using T = U256;
  static T add(const T& a, const T& b) { return FQ().add(a, b); }
  static T sub(const T& a, const T& b) { return FQ().sub(a, b); }
  static T neg(const T& a) { return FQ().neg(a); }
  static T mul(const T& a, const T& b) { return FQ().mul(a, b); }
  static T sqr(const T& a) { return FQ().sqr(a); }
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
  const Mont& F = FQ();
  U256 lhs = F.sqr(p.y);
  U256 rhs = F.add(F.mul(F.sqr(p.x), p.x), B1());
  return lhs == rhs;
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
