// C ABI of the Groth16 prover's host tail (consumed via ctypes from
// infimum_tpu_torch/native): each MSM's window sums combined into one point
// (Horner over the windows), then the proof's three points assembled from
// the five sums, the key and r, s — in Jacobian coordinates over bn254.h's
// arithmetic, with one inversion for each point returned.
//
// Points cross the ABI in standard form, 32-byte little-endian coordinates:
// G1 x, y (64 bytes); G2 x.c0, x.c1, y.c0, y.c1 (128 bytes). All zero bytes
// stand for infinity, which no curve point has as its coordinates.
#include <cstdint>
#include <type_traits>

#include "bn254.h"

using namespace inf;

namespace {

constexpr int kWordsFq = 8;  // 32-bit words of one Fq in the window sums

// One Fq of the window sums: 8 little-endian 32-bit words, Montgomery form
// (R = 2^256, as the Fq ops here), brought below q.
U256 fq_from_words(const uint32_t* w) {
  U256 r;
  for (int i = 0; i < 4; ++i) r.v[i] = u64(w[2 * i]) | u64(w[2 * i + 1]) << 32;
  while (cmp(r, FQ().mod) >= 0) subb(r, r, FQ().mod);
  return r;
}

// The field of a point, its element read from window-sum words and its
// coordinates' bytes at the ABI.
template <typename Ops>
struct Field;

template <>
struct Field<FqOps> {
  static constexpr int kWords = kWordsFq, kBytes = 32;
  static U256 from_words(const uint32_t* w) { return fq_from_words(w); }
  // false where the coordinate is not below q
  static bool read(const uint8_t* b, U256* x) {
    U256 v = from_le32(b);
    if (cmp(v, FQ().mod) >= 0) return false;
    *x = FQ().to_mont(v);
    return true;
  }
  static void write(const U256& x, uint8_t* b) { to_le32(FQ().from_mont(x), b); }
};

template <>
struct Field<Fq2Ops> {
  static constexpr int kWords = 2 * kWordsFq, kBytes = 64;
  static Fq2 from_words(const uint32_t* w) {
    return {fq_from_words(w), fq_from_words(w + kWordsFq)};
  }
  static bool read(const uint8_t* b, Fq2* x) {
    return Field<FqOps>::read(b, &x->c0) && Field<FqOps>::read(b + 32, &x->c1);
  }
  static void write(const Fq2& x, uint8_t* b) {
    Field<FqOps>::write(x.c0, b);
    Field<FqOps>::write(x.c1, b + 32);
  }
};

template <typename Ops>
Jac<Ops> infinity() {
  return {Ops::one(), Ops::one(), Ops::zero()};
}

template <typename Ops>
bool all_zero(const uint8_t* b) {
  for (int i = 0; i < 2 * Field<Ops>::kBytes; ++i)
    if (b[i]) return false;
  return true;
}

// An affine point from the ABI's bytes; false where it is off its curve.
template <typename Ops>
bool read_point(const uint8_t* b, Jac<Ops>* p) {
  using F = Field<Ops>;
  if (all_zero<Ops>(b)) {
    *p = infinity<Ops>();
    return true;
  }
  Affine<Ops> a;
  if (!F::read(b, &a.x) || !F::read(b + F::kBytes, &a.y)) return false;
  a.inf = false;
  bool on;
  if constexpr (std::is_same_v<Ops, FqOps>)
    on = g1_on_curve(a);
  else
    on = g2_on_curve(a);
  if (!on) return false;
  *p = jac_from_affine(a);
  return true;
}

template <typename Ops>
void write_point(const Jac<Ops>& p, uint8_t* b) {
  using F = Field<Ops>;
  Affine<Ops> a = jac_to_affine(p);
  if (a.inf) {
    for (int i = 0; i < 2 * F::kBytes; ++i) b[i] = 0;
    return;
  }
  F::write(a.x, b);
  F::write(a.y, b + F::kBytes);
}

// Sum of digit * window over the windows, least significant first: Horner
// from the top window down. A window sum is homogeneous projective
// (X, Y, Z) = (X/Z, Y/Z), the MSM kernels' complete formulas'; it enters
// as the Jacobian (X Z, Y Z^2, Z), the same point.
template <typename Ops>
int combine(const uint32_t* words, int nwin, int c_bits, uint8_t* out) {
  if (nwin < 0 || c_bits < 0 || c_bits > 64) return -1;
  constexpr int kF = Field<Ops>::kWords;
  Jac<Ops> acc = infinity<Ops>();
  for (int w = nwin - 1; w >= 0; --w) {
    for (int i = 0; i < c_bits; ++i) acc = jac_double(acc);
    const uint32_t* p = words + 3 * kF * w;
    auto x = Field<Ops>::from_words(p), y = Field<Ops>::from_words(p + kF),
         z = Field<Ops>::from_words(p + 2 * kF);
    acc = jac_add(acc, {Ops::mul(x, z), Ops::mul(y, Ops::sqr(z)), z});
  }
  write_point(acc, out);
  return 0;
}

// k p by a fixed 4-bit window: the multiples 0..15 of p, then 4 doublings
// and at most one addition for each of k's 64 nibbles, top first.
template <typename Ops>
Jac<Ops> mul_w4(const Jac<Ops>& p, const U256& k) {
  Jac<Ops> tab[16];
  tab[0] = infinity<Ops>();
  for (int d = 1; d < 16; ++d) tab[d] = jac_add(tab[d - 1], p);
  Jac<Ops> acc = infinity<Ops>();
  for (int n = 63; n >= 0; --n) {
    for (int i = 0; i < 4; ++i) acc = jac_double(acc);
    int d = int(k.v[n / 16] >> (4 * (n % 16))) & 15;
    if (d) acc = jac_add(acc, tab[d]);
  }
  return acc;
}

template <typename Ops>
Jac<Ops> jac_neg(const Jac<Ops>& p) {
  return {p.x, Ops::neg(p.y), p.z};
}

}  // namespace

extern "C" {

// One MSM's window sums -> its point. words: nwin x (X, Y, Z) of 8 (G1) or
// 16 (G2: c0 then c1) 32-bit words each, as the MSM's weighted kernel writes
// them; the windows c_bits apart, least significant first. out: the point
// as at the ABI. Returns 0, or -1 on nwin or c_bits out of range.
int inf_msm_combine_g1(const uint32_t* words, int nwin, int c_bits,
                       uint8_t* out) {
  return combine<FqOps>(words, nwin, c_bits, out);
}

int inf_msm_combine_g2(const uint32_t* words, int nwin, int c_bits,
                       uint8_t* out) {
  return combine<Fq2Ops>(words, nwin, c_bits, out);
}

// The proof's points from the key, the five MSMs' points and r, s:
//   A = alpha + a + r delta,  B = beta_2 + b2 + s delta_2,
//   C = l + h + s A + r (beta_1 + b1 + s delta) - (r s mod |Fr|) delta.
// key: alpha_g1, beta_g1, delta_g1 (64 bytes each), beta_g2, delta_g2 (128
// each); sums: a, b1, l, h (64 each), b2 (128); r, s: 32-byte little-endian
// integers below |Fr|; out: A (64), B (128), C (64). Returns 0, -1 on a
// point off its curve, -2 on r or s out of range.
int inf_groth16_assemble(const uint8_t* key, const uint8_t* sums,
                         const uint8_t* r_le, const uint8_t* s_le,
                         uint8_t* out) {
  Jac<FqOps> alpha, beta1, delta1, a, b1, l, h;
  Jac<Fq2Ops> beta2, delta2, b2;
  if (!read_point(key, &alpha) || !read_point(key + 64, &beta1) ||
      !read_point(key + 128, &delta1) || !read_point(key + 192, &beta2) ||
      !read_point(key + 320, &delta2) || !read_point(sums, &a) ||
      !read_point(sums + 64, &b1) || !read_point(sums + 128, &l) ||
      !read_point(sums + 192, &h) || !read_point(sums + 256, &b2))
    return -1;
  const Mont& fr = FR();
  U256 r = from_le32(r_le), s = from_le32(s_le);
  if (cmp(r, fr.mod) >= 0 || cmp(s, fr.mod) >= 0) return -2;
  U256 rs = fr.mul(fr.mul(r, s), fr.r2);  // r s / R, times R^2 / R

  Jac<FqOps> pa = jac_add(jac_add(alpha, a), mul_w4(delta1, r));
  Jac<Fq2Ops> pb = jac_add(jac_add(beta2, b2), mul_w4(delta2, s));
  Jac<FqOps> pb1 = jac_add(jac_add(beta1, b1), mul_w4(delta1, s));
  Jac<FqOps> pc = jac_add(l, h);
  pc = jac_add(pc, mul_w4(pa, s));
  pc = jac_add(pc, mul_w4(pb1, r));
  pc = jac_add(pc, jac_neg(mul_w4(delta1, rs)));
  write_point(pa, out);
  write_point(pb, out + 64);
  write_point(pc, out + 192);
  return 0;
}

}  // extern "C"
