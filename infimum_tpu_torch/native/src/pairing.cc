// The tower pairing; see pairing.h.
#include "pairing.h"

namespace inf {
namespace {

// ---- Fq2: what the tower adds to bn254.h's --------------------------------

Fq2 fq2_dbl(const Fq2& a) { return fq2_add(a, a); }
Fq2 fq2_conj(const Fq2& a) { return {a.c0, fq_neg(a.c1)}; }

Fq2 fq2_scale(const Fq2& a, const U256& s) {
  return {fq_mul(a.c0, s), fq_mul(a.c1, s)};
}

U256 times9(const U256& x) {
  U256 x2 = fq_add(x, x), x4 = fq_add(x2, x2), x8 = fq_add(x4, x4);
  return fq_add(x8, x);
}
// a * xi = (9 a0 - a1) + (a0 + 9 a1) u
Fq2 fq2_mul_xi(const Fq2& a) {
  return {fq_sub(times9(a.c0), a.c1), fq_add(a.c0, times9(a.c1))};
}

Fq2 fq2_pow(const Fq2& a, const U256& e) {
  Fq2 r = Fq2Ops::one(), base = a;
  for (int i = 0, n = e.bit_length(); i < n; ++i) {
    if (e.bit(i)) r = fq2_mul(r, base);
    base = fq2_sqr(base);
  }
  return r;
}

// ---- Fq6 = Fq2[v]/(v^3 - xi) ----------------------------------------------

Fq6 f6_add(const Fq6& a, const Fq6& b) {
  return {fq2_add(a.c0, b.c0), fq2_add(a.c1, b.c1), fq2_add(a.c2, b.c2)};
}
Fq6 f6_sub(const Fq6& a, const Fq6& b) {
  return {fq2_sub(a.c0, b.c0), fq2_sub(a.c1, b.c1), fq2_sub(a.c2, b.c2)};
}
Fq6 f6_neg(const Fq6& a) {
  return {fq2_neg(a.c0), fq2_neg(a.c1), fq2_neg(a.c2)};
}
Fq6 f6_mul_v(const Fq6& a) { return {fq2_mul_xi(a.c2), a.c0, a.c1}; }
Fq6 f6_scale(const Fq6& a, const Fq2& s) {
  return {fq2_mul(a.c0, s), fq2_mul(a.c1, s), fq2_mul(a.c2, s)};
}

// Karatsuba: 6 Fq2 products.
Fq6 f6_mul(const Fq6& a, const Fq6& b) {
  Fq2 t0 = fq2_mul(a.c0, b.c0), t1 = fq2_mul(a.c1, b.c1),
      t2 = fq2_mul(a.c2, b.c2);
  Fq2 c0 = fq2_sub(fq2_mul(fq2_add(a.c1, a.c2), fq2_add(b.c1, b.c2)),
                   fq2_add(t1, t2));
  Fq2 c1 = fq2_sub(fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b.c0, b.c1)),
                   fq2_add(t0, t1));
  Fq2 c2 = fq2_sub(fq2_mul(fq2_add(a.c0, a.c2), fq2_add(b.c0, b.c2)),
                   fq2_sub(fq2_add(t0, t2), t1));
  return {fq2_add(fq2_mul_xi(c0), t0), fq2_add(c1, fq2_mul_xi(t2)), c2};
}

// Chung-Hasan SQR2: 2 Fq2 products and 3 squares.
Fq6 f6_sqr(const Fq6& a) {
  Fq2 s0 = fq2_sqr(a.c0);
  Fq2 s1 = fq2_dbl(fq2_mul(a.c0, a.c1));
  Fq2 s2 = fq2_sqr(fq2_add(fq2_sub(a.c0, a.c1), a.c2));
  Fq2 s3 = fq2_dbl(fq2_mul(a.c1, a.c2));
  Fq2 s4 = fq2_sqr(a.c2);
  return {fq2_add(s0, fq2_mul_xi(s3)), fq2_add(s1, fq2_mul_xi(s4)),
          fq2_sub(fq2_add(fq2_add(s1, s2), s3), fq2_add(s0, s4))};
}

// a (b0 + b1 v): 5 Fq2 products.
Fq6 f6_mul_01(const Fq6& a, const Fq2& b0, const Fq2& b1) {
  Fq2 aa = fq2_mul(a.c0, b0), bb = fq2_mul(a.c1, b1);
  Fq2 c0 = fq2_add(
      fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a.c1, a.c2), b1), bb)), aa);
  Fq2 c1 = fq2_sub(fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b0, b1)),
                   fq2_add(aa, bb));
  Fq2 c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a.c0, a.c2), b0), aa), bb);
  return {c0, c1, c2};
}

Fq6 f6_inv(const Fq6& a) {
  Fq2 c0 = fq2_sub(fq2_sqr(a.c0), fq2_mul_xi(fq2_mul(a.c1, a.c2)));
  Fq2 c1 = fq2_sub(fq2_mul_xi(fq2_sqr(a.c2)), fq2_mul(a.c0, a.c1));
  Fq2 c2 = fq2_sub(fq2_sqr(a.c1), fq2_mul(a.c0, a.c2));
  Fq2 norm = fq2_add(
      fq2_mul(a.c0, c0),
      fq2_mul_xi(fq2_add(fq2_mul(a.c2, c1), fq2_mul(a.c1, c2))));
  return f6_scale({c0, c1, c2}, fq2_inv(norm));
}

// ---- Fq12 = Fq6[w]/(w^2 - v) ----------------------------------------------

// Karatsuba: 3 Fq6 products.
Fq12 f12_mul(const Fq12& a, const Fq12& b) {
  Fq6 t0 = f6_mul(a.c0, b.c0), t1 = f6_mul(a.c1, b.c1);
  Fq6 c1 = f6_sub(f6_mul(f6_add(a.c0, a.c1), f6_add(b.c0, b.c1)),
                  f6_add(t0, t1));
  return {f6_add(t0, f6_mul_v(t1)), c1};
}

// Complex squaring: 2 Fq6 products.
Fq12 f12_sqr(const Fq12& a) {
  Fq6 ab = f6_mul(a.c0, a.c1);
  Fq6 c0 = f6_sub(f6_mul(f6_add(a.c0, a.c1), f6_add(a.c0, f6_mul_v(a.c1))),
                  f6_add(ab, f6_mul_v(ab)));
  return {c0, f6_add(ab, ab)};
}

// a^(q^6): the inverse of a unitary element.
Fq12 f12_conj(const Fq12& a) { return {a.c0, f6_neg(a.c1)}; }

// 1/(c0 + c1 w) = (c0 - c1 w)/(c0^2 - v c1^2), one Fq2 inversion.
Fq12 f12_inv(const Fq12& a) {
  Fq6 t = f6_inv(f6_sub(f6_sqr(a.c0), f6_mul_v(f6_sqr(a.c1))));
  return {f6_mul(a.c0, t), f6_neg(f6_mul(a.c1, t))};
}

// f * (c0 + c3 w + c4 w^3) = f * (c0 + (c3 + c4 v) w): the shape of every
// line on the D-type twist.
Fq12 f12_mul_034(const Fq12& f, const Fq2& c0, const Fq2& c3,
                 const Fq2& c4) {
  Fq6 a = {fq2_mul(f.c0.c0, c0), fq2_mul(f.c0.c1, c0), fq2_mul(f.c0.c2, c0)};
  Fq6 b = f6_mul_01(f.c1, c3, c4);
  Fq6 e = f6_mul_01(f6_add(f.c0, f.c1), fq2_add(c0, c3), c4);
  return {f6_add(a, f6_mul_v(b)), f6_sub(e, f6_add(a, b))};
}

// Granger-Scott squaring of an element of the cyclotomic subgroup (every
// value past the easy part): 6 Fq2 products. The pairs (z0, z1), (z2, z3),
// (z4, z5) are the element's coefficients over Fq4 = Fq2[w^3].
Fq12 f12_cyc_sqr(const Fq12& a) {
  const Fq2 &z0 = a.c0.c0, &z4 = a.c0.c1, &z3 = a.c0.c2, &z2 = a.c1.c0,
            &z1 = a.c1.c1, &z5 = a.c1.c2;
  // (x + y w^3)^2 = (x^2 + xi y^2) + 2 x y w^3
  auto fq4_sqr = [](const Fq2& x, const Fq2& y, Fq2* t0, Fq2* t1) {
    Fq2 xy = fq2_mul(x, y);
    *t0 = fq2_sub(fq2_mul(fq2_add(x, y), fq2_add(fq2_mul_xi(y), x)),
                  fq2_add(xy, fq2_mul_xi(xy)));
    *t1 = fq2_dbl(xy);
  };
  Fq2 t0, t1, t2, t3, t4, t5;
  fq4_sqr(z0, z1, &t0, &t1);
  fq4_sqr(z2, z3, &t2, &t3);
  fq4_sqr(z4, z5, &t4, &t5);
  auto three_minus_two = [](const Fq2& t, const Fq2& z) {  // 3t - 2z
    return fq2_add(fq2_dbl(fq2_sub(t, z)), t);
  };
  auto three_plus_two = [](const Fq2& t, const Fq2& z) {  // 3t + 2z
    return fq2_add(fq2_dbl(fq2_add(t, z)), t);
  };
  Fq12 r;
  r.c0.c0 = three_minus_two(t0, z0);
  r.c1.c1 = three_plus_two(t1, z1);
  r.c1.c0 = three_plus_two(fq2_mul_xi(t5), z2);
  r.c0.c2 = three_minus_two(t4, z3);
  r.c0.c1 = three_minus_two(t2, z4);
  r.c1.c2 = three_plus_two(t3, z5);
  return r;
}

// Signed digits of n, least significant first, no two adjacent nonzero.
std::vector<int> naf(u128 n) {
  std::vector<int> d;
  while (n) {
    int digit = 0;
    if (n & 1) {
      digit = (n & 3) == 1 ? 1 : -1;
      n = digit == 1 ? n - 1 : n + 1;
    }
    d.push_back(digit);
    n >>= 1;
  }
  return d;
}

constexpr u64 BN_X = 4965661367192848881ULL;

// a^x for a cyclotomic a, where a^-1 = conj(a).
Fq12 f12_cyc_exp_x(const Fq12& a) {
  static const std::vector<int> X_NAF = naf(BN_X);
  Fq12 inv = f12_conj(a), r = a;  // the top digit is 1
  for (int i = (int)X_NAF.size() - 2; i >= 0; --i) {
    r = f12_cyc_sqr(r);
    if (X_NAF[i] == 1) r = f12_mul(r, a);
    if (X_NAF[i] == -1) r = f12_mul(r, inv);
  }
  return r;
}

// ---- Frobenius by constant coefficients -----------------------------------

// GAMMA[k][i] = xi^(i (q^k - 1)/6): w^(i q^k) = GAMMA[k][i] w^i.
struct Frobenius {
  Fq2 g[4][6];
  Frobenius() {
    U256 e = FQ().mod;  // (q - 1)/6
    e.v[0] -= 1;
    u128 rem = 0;
    for (int w = 3; w >= 0; --w) {
      u128 cur = (rem << 64) | e.v[w];
      e.v[w] = (u64)(cur / 6);
      rem = cur % 6;
    }
    Fq2 xi = {FQ().to_mont(U256{{9, 0, 0, 0}}), FQ().one_m};
    Fq2 g1 = fq2_pow(xi, e), gk = g1;
    for (int k = 1; k <= 3; ++k) {
      // (q^k - 1)/6 = q (q^(k-1) - 1)/6 + (q - 1)/6
      if (k > 1) gk = fq2_mul(fq2_conj(gk), g1);
      g[k][0] = Fq2Ops::one();
      for (int i = 1; i < 6; ++i) g[k][i] = fq2_mul(g[k][i - 1], gk);
    }
  }
};

const Frobenius& FROB() {
  static const Frobenius f;
  return f;
}

// a^(q^k), k = 1, 2, 3: conjugate each Fq2 coefficient k times, scale the
// coefficient of w^i by GAMMA[k][i].
Fq12 f12_frob(const Fq12& a, int k) {
  const Fq2* g = FROB().g[k];
  auto c = [&](const Fq2& x, int i) {
    Fq2 y = (k & 1) ? fq2_conj(x) : x;
    return i ? fq2_mul(y, g[i]) : y;
  };
  // coefficient of w^i: c0.c0 = 1, c1.c0 = w, c0.c1 = w^2, c1.c1 = w^3,
  // c0.c2 = w^4, c1.c2 = w^5
  return {{c(a.c0.c0, 0), c(a.c0.c1, 2), c(a.c0.c2, 4)},
          {c(a.c1.c0, 1), c(a.c1.c1, 3), c(a.c1.c2, 5)}};
}

// ---- the Miller loop on the twist -----------------------------------------

// A point of the twist in homogeneous projective coordinates, x = X/Z,
// y = Y/Z.
struct G2Proj {
  Fq2 x, y, z;
};

// A line through points of the twist, evaluated at P as c0 py + c3 px w +
// c4 w^3, scaled by a factor in Fq2 that the final exponentiation removes.
struct Line {
  Fq2 c0, c3, c4;
};

// T = 2T and the tangent at T (Costello-Lange-Naehrig 2010 as ark-ec's
// `G2HomProjective::double_in_place` has it, with X, Y, Z taken 4 times over
// so that nothing is halved).
Line double_step(G2Proj* t) {
  Fq2 a = fq2_mul(t->x, t->y);
  Fq2 b = fq2_sqr(t->y);
  Fq2 c = fq2_sqr(t->z);
  Fq2 e = fq2_mul(B2(), fq2_add(fq2_dbl(c), c));
  Fq2 f = fq2_add(fq2_dbl(e), e);
  Fq2 h = fq2_sub(fq2_sqr(fq2_add(t->y, t->z)), fq2_add(b, c));
  Fq2 i = fq2_sub(e, b);
  Fq2 j = fq2_sqr(t->x);
  Fq2 e2 = fq2_dbl(fq2_sqr(e));
  Fq2 e12 = fq2_dbl(fq2_add(fq2_dbl(e2), e2));
  t->x = fq2_dbl(fq2_mul(a, fq2_sub(b, f)));
  t->y = fq2_sub(fq2_sqr(fq2_add(b, f)), e12);
  t->z = fq2_dbl(fq2_dbl(fq2_mul(b, h)));
  return {fq2_neg(h), fq2_add(fq2_dbl(j), j), i};
}

// T = T + Q and the line through them (ark-ec's `add_in_place`).
Line add_step(G2Proj* t, const G2& q) {
  Fq2 theta = fq2_sub(t->y, fq2_mul(q.y, t->z));
  Fq2 lambda = fq2_sub(t->x, fq2_mul(q.x, t->z));
  Fq2 c = fq2_sqr(theta);
  Fq2 d = fq2_sqr(lambda);
  Fq2 e = fq2_mul(lambda, d);
  Fq2 f = fq2_mul(t->z, c);
  Fq2 g = fq2_mul(t->x, d);
  Fq2 h = fq2_sub(fq2_add(e, f), fq2_dbl(g));
  t->x = fq2_mul(lambda, h);
  t->y = fq2_sub(fq2_mul(theta, fq2_sub(g, h)), fq2_mul(e, t->y));
  t->z = fq2_mul(t->z, e);
  Fq2 j = fq2_sub(fq2_mul(theta, q.x), fq2_mul(lambda, q.y));
  return {lambda, fq2_neg(theta), j};
}

Fq12 ell(const Fq12& f, const Line& l, const G1& p) {
  return f12_mul_034(f, fq2_scale(l.c0, p.y), fq2_scale(l.c3, p.x), l.c4);
}

// The q-power Frobenius carried onto the twist: psi^-1 pi psi.
G2 twist_frob(const G2& q) {
  const Fq2* g = FROB().g[1];
  G2 r = q;
  r.x = fq2_mul(fq2_conj(q.x), g[2]);
  r.y = fq2_mul(fq2_conj(q.y), g[3]);
  return r;
}

G1 g1_neg(G1 p) {
  if (!p.inf) p.y = fq_neg(p.y);
  return p;
}

G2 g2_neg(G2 q) {
  q.y = fq2_neg(q.y);
  return q;
}

}  // namespace

Fq12 fq12_one() {
  Fq12 r{};
  r.c0.c0 = Fq2Ops::one();
  return r;
}

Fq12 multi_miller_loop(const std::vector<std::pair<G1, G2>>& pairs) {
  // 6x + 2, signed digits; the top digit is 1, so each T starts at Q
  static const std::vector<int> ATE_NAF = naf((u128)BN_X * 6 + 2);
  struct Pair {
    G1 p;
    G2 q, neg_q;
    G2Proj t;
  };
  std::vector<Pair> ps;
  for (const auto& [p, q] : pairs)
    if (!p.inf && !q.inf)
      ps.push_back({p, q, g2_neg(q), {q.x, q.y, Fq2Ops::one()}});

  Fq12 f = fq12_one();
  for (int i = (int)ATE_NAF.size() - 2; i >= 0; --i) {
    if (i != (int)ATE_NAF.size() - 2) f = f12_sqr(f);
    for (Pair& s : ps) f = ell(f, double_step(&s.t), s.p);
    if (ATE_NAF[i])
      for (Pair& s : ps)
        f = ell(f, add_step(&s.t, ATE_NAF[i] > 0 ? s.q : s.neg_q), s.p);
  }
  // T = [6x+2]Q; the lines through T and pi(Q), then T + pi(Q) and -pi^2(Q)
  for (Pair& s : ps) {
    G2 q1 = twist_frob(s.q);
    G2 q2 = g2_neg(twist_frob(q1));
    f = ell(f, add_step(&s.t, q1), s.p);
    f = ell(f, add_step(&s.t, q2), s.p);
  }
  return f;
}

Fq12 final_exponentiate(const Fq12& f) {
  // easy part: r = f^((q^6 - 1)(q^2 + 1))
  Fq12 r = f12_mul(f12_conj(f), f12_inv(f));
  r = f12_mul(f12_frob(r, 2), r);
  // hard part, ark-ec's chain (Fuentes-Castaneda et al. 2011): r to the
  // power q^3 (12x^3 + 6x^2 + 4x - 1) + q^2 (12x^3 + 6x^2 + 6x)
  //   + q (12x^3 + 6x^2 + 4x) + (12x^3 + 12x^2 + 6x + 1)
  //   = 2x (6x^2 + 3x + 1) (q^4 - q^2 + 1)/r. Here x > 0, so each power by
  // -x is the conjugate of the power by x.
  auto exp_neg_x = [](const Fq12& a) { return f12_conj(f12_cyc_exp_x(a)); };
  Fq12 y0 = exp_neg_x(r);
  Fq12 y1 = f12_cyc_sqr(y0);
  Fq12 y2 = f12_cyc_sqr(y1);
  Fq12 y3 = f12_mul(y2, y1);
  Fq12 y4 = exp_neg_x(y3);
  Fq12 y5 = f12_cyc_sqr(y4);
  Fq12 y6 = exp_neg_x(y5);
  y3 = f12_conj(y3);
  y6 = f12_conj(y6);
  Fq12 y7 = f12_mul(y6, y4);
  Fq12 y8 = f12_mul(y7, y3);
  Fq12 y9 = f12_mul(y8, y1);
  Fq12 y10 = f12_mul(y8, y4);
  Fq12 y11 = f12_mul(y10, r);
  Fq12 y13 = f12_mul(f12_frob(y9, 1), y11);
  Fq12 y14 = f12_mul(f12_frob(y8, 2), y13);
  Fq12 y15 = f12_frob(f12_mul(f12_conj(r), y9), 3);
  return f12_mul(y15, y14);
}

void fq12_to_poly(const Fq12& a, U256 out[12]) {
  // the coefficient x + y u of w^i is (x - 9y) w^i + y w^(i+6)
  const Fq2* by_power[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                            &a.c1.c1, &a.c0.c2, &a.c1.c2};
  for (int i = 0; i < 6; ++i) {
    const Fq2& x = *by_power[i];
    out[i] = FQ().from_mont(fq_sub(x.c0, times9(x.c1)));
    out[i + 6] = FQ().from_mont(x.c1);
  }
}

Fq12 groth16_miller_product(const VerifyingKey& vk, const Proof& proof,
                            const std::vector<U256>& publics) {
  // acc = IC[0] + sum publics[i] * IC[i+1]
  Jac<FqOps> acc = jac_from_affine(vk.ic[0]);
  for (size_t i = 0; i < publics.size(); ++i) {
    if (publics[i].is_zero()) continue;
    acc = jac_add(acc, jac_mul(jac_from_affine(vk.ic[i + 1]), publics[i]));
  }
  G1 acc_aff = jac_to_affine(acc);

  // e(A,B) * e(-acc, gamma) * e(-C, delta) * e(-alpha, beta) == 1
  return multi_miller_loop({{proof.a, proof.b},
                            {g1_neg(acc_aff), vk.gamma_g2},
                            {g1_neg(proof.c), vk.delta_g2},
                            {g1_neg(vk.alpha_g1), vk.beta_g2}});
}

}  // namespace inf
