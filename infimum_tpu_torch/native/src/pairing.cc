// Copied from native/src/pairing.cc; see pairing.h.
#include "pairing.h"

#include <cassert>

namespace inf {
namespace {

const Mont& F() { return FQ(); }

// ---- Fq12 = Fq[w]/(w^12 - 18 w^6 + 82) -----------------------------------

Fq12 fq12_zero() { return {}; }

Fq12 fq12_add(const Fq12& a, const Fq12& b) {
  Fq12 r;
  for (int i = 0; i < 12; ++i) r.c[i] = F().add(a.c[i], b.c[i]);
  return r;
}

Fq12 fq12_sub(const Fq12& a, const Fq12& b) {
  Fq12 r;
  for (int i = 0; i < 12; ++i) r.c[i] = F().sub(a.c[i], b.c[i]);
  return r;
}

U256 mont_small(u64 k) { return F().to_mont(U256{{k, 0, 0, 0}}); }

}  // namespace

Fq12 fq12_one() {
  Fq12 r;
  r.c[0] = F().one_m;
  return r;
}

Fq12 fq12_mul(const Fq12& a, const Fq12& b) {
  static const U256 M18 = mont_small(18);
  static const U256 M82 = mont_small(82);
  U256 t[23] = {};
  for (int i = 0; i < 12; ++i) {
    if (a.c[i].is_zero()) continue;
    for (int j = 0; j < 12; ++j)
      t[i + j] = F().add(t[i + j], F().mul(a.c[i], b.c[j]));
  }
  // reduce by w^12 = 18 w^6 - 82
  for (int i = 22; i >= 12; --i) {
    if (t[i].is_zero()) continue;
    U256 top = t[i];
    t[i] = U256{};
    t[i - 6] = F().add(t[i - 6], F().mul(top, M18));
    t[i - 12] = F().sub(t[i - 12], F().mul(top, M82));
  }
  Fq12 r;
  for (int i = 0; i < 12; ++i) r.c[i] = t[i];
  return r;
}

namespace {

Fq12 fq12_sqr(const Fq12& a) { return fq12_mul(a, a); }

// a^e for a multi-word exponent (little-endian 64-bit words)
Fq12 fq12_pow(const Fq12& a, const std::vector<u64>& e) {
  Fq12 result = fq12_one(), base = a;
  int nbits = 0;
  for (int w = (int)e.size() - 1; w >= 0; --w)
    if (e[w]) {
      nbits = 64 * w + 64 - __builtin_clzll(e[w]);
      break;
    }
  for (int i = 0; i < nbits; ++i) {
    if ((e[i >> 6] >> (i & 63)) & 1) result = fq12_mul(result, base);
    base = fq12_sqr(base);
  }
  return result;
}

std::vector<u64> hex_words(const char* s) {
  std::vector<u64> out;
  int n = (int)std::strlen(s);
  for (int start = n; start > 0; start -= 16) {
    int from = start >= 16 ? start - 16 : 0;
    u64 w = 0;
    for (int i = from; i < start; ++i) {
      char c = s[i];
      u64 d = (c >= '0' && c <= '9') ? c - '0'
              : (c >= 'a' && c <= 'f') ? c - 'a' + 10
                                       : c - 'A' + 10;
      w = (w << 4) | d;
    }
    out.push_back(w);
  }
  return out;
}

int poly_deg(const std::vector<U256>& p) {
  int d = (int)p.size() - 1;
  while (d > 0 && p[d].is_zero()) --d;
  return d;
}

std::vector<U256> poly_div(const std::vector<U256>& a,
                           const std::vector<U256>& b) {
  int da = poly_deg(a), db = poly_deg(b);
  std::vector<U256> temp = a, o(a.size());
  U256 binv = F().inv(b[db]);
  for (int i = da - db; i >= 0; --i) {
    o[i] = F().add(o[i], F().mul(temp[db + i], binv));
    for (int c = 0; c <= db; ++c)
      temp[c + i] = F().sub(temp[c + i], F().mul(o[i], b[c]));
  }
  o.resize(poly_deg(o) + 1);
  return o;
}

}  // namespace

Fq12 fq12_inv(const Fq12& a) {
  // extended Euclid over Fq[w] modulo w^12 - 18w^6 + 82 (curve/pairing.py
  // structure). All coefficients Montgomery-form.
  static const U256 M18 = mont_small(18);
  static const U256 M82 = mont_small(82);
  const int D = 12;
  std::vector<U256> lm(D + 1), hm(D + 1), low(D + 1), high(D + 1);
  lm[0] = F().one_m;
  for (int i = 0; i < D; ++i) low[i] = a.c[i];
  high[0] = M82;
  high[6] = F().neg(M18);
  high[12] = F().one_m;

  while (poly_deg(low) > 0) {
    std::vector<U256> r = poly_div(high, low);
    r.resize(D + 1);
    std::vector<U256> nm = hm, nw = high;
    for (int i = 0; i <= D; ++i)
      for (int j = 0; j <= D - i; ++j) {
        nm[i + j] = F().sub(nm[i + j], F().mul(lm[i], r[j]));
        nw[i + j] = F().sub(nw[i + j], F().mul(low[i], r[j]));
      }
    hm = lm;
    high = low;
    lm = nm;
    low = nw;
  }
  U256 linv = F().inv(low[0]);
  Fq12 out;
  for (int i = 0; i < D; ++i) out.c[i] = F().mul(lm[i], linv);
  return out;
}

namespace {

// E(Fq12) point arithmetic (affine, with line evaluation)
struct P12 {
  Fq12 x, y;
};

P12 p12_double(const P12& p) {
  Fq12 x2 = fq12_mul(p.x, p.x);
  Fq12 num = fq12_add(fq12_add(x2, x2), x2);  // 3x^2
  Fq12 den = fq12_add(p.y, p.y);
  Fq12 l = fq12_mul(num, fq12_inv(den));
  Fq12 nx = fq12_sub(fq12_mul(l, l), fq12_add(p.x, p.x));
  Fq12 ny = fq12_sub(fq12_mul(l, fq12_sub(p.x, nx)), p.y);
  return {nx, ny};
}

P12 p12_add(const P12& p, const P12& q) {
  if (p.x == q.x && p.y == q.y) return p12_double(p);
  Fq12 l = fq12_mul(fq12_sub(q.y, p.y), fq12_inv(fq12_sub(q.x, p.x)));
  Fq12 nx = fq12_sub(fq12_mul(l, l), fq12_add(p.x, q.x));
  Fq12 ny = fq12_sub(fq12_mul(l, fq12_sub(p.x, nx)), p.y);
  return {nx, ny};
}

Fq12 linefunc(const P12& p1, const P12& p2, const P12& t) {
  if (p1.x == p2.x && p1.y == p2.y) {
    Fq12 x2 = fq12_mul(p1.x, p1.x);
    Fq12 mnum = fq12_add(fq12_add(x2, x2), x2);
    Fq12 mden = fq12_add(p1.y, p1.y);
    return fq12_sub(fq12_mul(mnum, fq12_sub(t.x, p1.x)),
                    fq12_mul(mden, fq12_sub(t.y, p1.y)));
  }
  if (p1.x == p2.x) return fq12_sub(t.x, p1.x);
  Fq12 mnum = fq12_sub(p2.y, p1.y);
  Fq12 mden = fq12_sub(p2.x, p1.x);
  return fq12_sub(fq12_mul(mnum, fq12_sub(t.x, p1.x)),
                  fq12_mul(mden, fq12_sub(t.y, p1.y)));
}

// twist: G2 ((x0,x1),(y0,y1)) -> E(Fq12); nx = (x0 - 9 x1) + x1 w^6, * w^2
P12 twist(const G2& q) {
  static const U256 M9 = mont_small(9);
  Fq12 nx, ny;
  nx.c[0] = F().sub(q.x.c0, F().mul(M9, q.x.c1));
  nx.c[6] = q.x.c1;
  ny.c[0] = F().sub(q.y.c0, F().mul(M9, q.y.c1));
  ny.c[6] = q.y.c1;
  // multiply nx by w^2, ny by w^3: nx/ny only occupy c[0] and c[6], so the
  // shifts land on c[2],c[8] and c[3],c[9] without reduction
  Fq12 nx2, ny3;
  nx2.c[2] = nx.c[0];
  nx2.c[8] = nx.c[6];
  ny3.c[3] = ny.c[0];
  ny3.c[9] = ny.c[6];
  return {nx2, ny3};
}

P12 cast_g1(const G1& p) {
  Fq12 x, y;
  x.c[0] = p.x;
  y.c[0] = p.y;
  return {x, y};
}

// frobenius: coefficient-wise x -> x^q on the polynomial basis
Fq12 fq12_frob(const Fq12& a) {
  static const std::vector<u64> QW = hex_words(FQ_HEX);
  Fq12 r;
  // x^q where x = sum c_i w^i: (w^i)^q = w^(i*q mod ...) is NOT diagonal on
  // this basis; compute via full pow instead (slow path, used 4x per loop).
  // a^q with a as ring element:
  return fq12_pow(a, QW);
}

// ate loop count 6x+2 = 29793968203157093288
constexpr u64 ATE_LO = 0x9d797039be763ba8ULL;
constexpr u64 ATE_HI = 0x1ULL;
inline bool ate_bit(int i) {
  return i < 64 ? (ATE_LO >> i) & 1 : (ATE_HI >> (i - 64)) & 1;
}
inline int ate_log() {
  return 64 + 64 - __builtin_clzll(ATE_HI) - 2;  // bit_length - 2
}

}  // namespace

Fq12 miller_loop(const G2& qg2, const G1& pg1) {
  if (qg2.inf || pg1.inf) return fq12_one();
  P12 q = twist(qg2);
  P12 p = cast_g1(pg1);
  P12 r = q;
  Fq12 f = fq12_one();
  for (int i = ate_log(); i >= 0; --i) {
    f = fq12_mul(fq12_mul(f, f), linefunc(r, r, p));
    r = p12_double(r);
    if (ate_bit(i)) {
      f = fq12_mul(f, linefunc(r, q, p));
      r = p12_add(r, q);
    }
  }
  P12 q1{fq12_frob(q.x), fq12_frob(q.y)};
  P12 nq2{fq12_frob(q1.x), fq12_sub(fq12_zero(), fq12_frob(q1.y))};
  f = fq12_mul(f, linefunc(r, q1, p));
  r = p12_add(r, q1);
  f = fq12_mul(f, linefunc(r, nq2, p));
  return f;
}

Fq12 final_exponentiate(const Fq12& f) {
  // staged (q^6-1), (q^2+1), (q^4-q^2+1)/r — exponents precomputed
  static const std::vector<u64> E1 = hex_words(
      "2fd70ffd469f22a255aea70a6ec3af1f18061c3d3019453500facde502233d9df3dc41c"
      "5830ecea5ef61762dd07aa2ee8ac393e1f970864ed3d397a42c302aebe67f05f148be14"
      "661aaf35ddfdf5c7e1c1d370decdf2128ec557b543fe50a1e1342fb2628372f294d1365"
      "6f6eb1608005dfa955bf9647ae01ee1f7c6ee6576cc7afd0826c9a44a0903665952d6b9"
      "25408128686d835cbdd0e6a4e64b8148fd65418b4cf130588725d28e938e58016bda8be"
      "6dec90ce20f4e90a2716e3f810");
  static const std::vector<u64> E2 = hex_words(
      "925c4b8763cbf9c599a6f7c0348d21cb00b85511637560626edfa5c34c6b38d04689e95"
      "7a1242c84a50189c6d96cadca602072d09eac1013b5458a2275d69b2");
  static const std::vector<u64> E3 = hex_words(
      "1baaa710b0759ad331ec15183177faf6c0eb522d5b122784e529a5861876f6b3b1b1355"
      "d189227d79581e16f3fd90c66b887d56d5095f23aaa441e3954bcf8adcc7b44c87cdbac"
      "ff1154e7e1da014fd5abf5cc4f49c36d4e81bb482ccdf42b1");
  Fq12 e1 = fq12_pow(f, E1);
  Fq12 e2 = fq12_pow(e1, E2);
  return fq12_pow(e2, E3);
}

Fq12 groth16_miller_product(const VerifyingKey& vk, const Proof& proof,
                            const std::vector<U256>& publics) {
  // acc = IC[0] + sum publics[i] * IC[i+1]
  Jac<FqOps> acc = jac_from_affine<FqOps>(vk.ic[0]);
  for (size_t i = 0; i < publics.size(); ++i) {
    if (publics[i].is_zero()) continue;
    auto term = jac_mul(jac_from_affine<FqOps>(vk.ic[i + 1]), publics[i]);
    acc = jac_add(acc, term);
  }
  G1 acc_aff = jac_to_affine(acc);

  // e(A,B) * e(-acc, gamma) * e(-C, delta) * e(-alpha, beta) == 1
  G1 neg_acc = acc_aff;
  if (!neg_acc.inf) neg_acc.y = F().neg(neg_acc.y);
  G1 neg_c = proof.c;
  if (!neg_c.inf) neg_c.y = F().neg(neg_c.y);
  G1 neg_alpha = vk.alpha_g1;
  if (!neg_alpha.inf) neg_alpha.y = F().neg(neg_alpha.y);

  Fq12 f = fq12_one();
  for (const auto& [p, q] : std::vector<std::pair<G1, G2>>{
           {proof.a, proof.b},
           {neg_acc, vk.gamma_g2},
           {neg_c, vk.delta_g2},
           {neg_alpha, vk.beta_g2}})
    f = fq12_mul(f, miller_loop(q, p));
  return f;
}

}  // namespace inf
