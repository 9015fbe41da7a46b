// The port's BN254 optimal-ate pairing and the Groth16 verifier's pairing
// product — native equivalent of ark-groth16's `process_vk` +
// `verify_with_processed_vk` (reference: pallet/src/lib.rs:815-827), built as
// ark-ec's `Bn::multi_miller_loop` and `Bn::final_exponentiation` are.
//
// Fq12 is a tower on bn254.h's Fq2 = Fq[u]/(u^2 + 1):
//   Fq6  = Fq2[v]/(v^3 - xi), xi = 9 + u;
//   Fq12 = Fq6[w]/(w^2 - v).
// It is the field of infimum_tpu/curve/pairing.py, whose polynomial basis is
// Fq[w]/(w^12 - 18 w^6 + 82): w^6 = xi, so u = w^6 - 9 (`fq12_to_poly`).
// G2 lies on the D-type twist y^2 = x^3 + 3/xi, mapped into E(Fq12) by
// (x, y) -> (x w^2, y w^3).
//
// The verifier splits the pairing where its caller times it: the multi-Miller
// loop (one accumulator for every pair; G2 points in homogeneous projective
// coordinates, so no step inverts; each line multiplied in sparsely), then
// the final exponentiation (the easy part by conjugate, one inverse and
// Frobenius; the hard part by a chain of three powers by x on cyclotomic
// squares).
#pragma once

#include <utility>
#include <vector>

#include "bn254.h"

namespace inf {

// Fq6 = c0 + c1 v + c2 v^2; Fq12 = c0 + c1 w. Montgomery-form coefficients.
struct Fq6 {
  Fq2 c0, c1, c2;
  bool operator==(const Fq6& o) const {
    return c0 == o.c0 && c1 == o.c1 && c2 == o.c2;
  }
};

struct Fq12 {
  Fq6 c0, c1;
  bool operator==(const Fq12& o) const { return c0 == o.c0 && c1 == o.c1; }
};

Fq12 fq12_one();

// prod_i f_{6x+2,Q_i}(P_i) with the two closing Frobenius lines, before the
// final exponentiation; a pair with a point at infinity is a factor of one.
Fq12 multi_miller_loop(const std::vector<std::pair<G1, G2>>& pairs);

// f^(k (q^12 - 1)/r) with k = 2x(6x^2 + 3x + 1), the power the hard part's
// chain gives (Fuentes-Castaneda et al. 2011). gcd(k, r) = 1, so the result
// is one exactly where f^((q^12 - 1)/r) is.
Fq12 final_exponentiate(const Fq12& f);

// The 12 standard-form coefficients of a on infimum_tpu/curve/pairing.py's
// polynomial basis, lowest power of w first.
void fq12_to_poly(const Fq12& a, U256 out[12]);

struct VerifyingKey {
  G1 alpha_g1;
  G2 beta_g2, gamma_g2, delta_g2;
  std::vector<G1> ic;
};

struct Proof {
  G1 a, c;
  G2 b;
};

// The verifier's multi-Miller loop over e(A,B) e(-acc,gamma) e(-C,delta)
// e(-alpha,beta), before the final exponentiation; the proof is valid where
// its final exponentiation is one. publics are plain Fr values, one per IC
// point past the first.
Fq12 groth16_miller_product(const VerifyingKey& vk, const Proof& proof,
                            const std::vector<U256>& publics);

}  // namespace inf
