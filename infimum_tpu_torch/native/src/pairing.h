// Copied from native/src/pairing.h; the verifier stops before the final
// exponentiation, so that its caller can time the two apart.
// BN254 optimal-ate pairing and the Groth16 verifier — native equivalent of
// ark-groth16's `process_vk` + `verify_with_processed_vk`
// (reference: pallet/src/lib.rs:815-827). Fq12 is the polynomial quotient
// ring Fq[w]/(w^12 - 18 w^6 + 82), mirroring curve/pairing.py.
#pragma once

#include <array>
#include <vector>

#include "bn254.h"

namespace inf {

struct Fq12 {
  std::array<U256, 12> c{};  // Montgomery-form coefficients
  bool operator==(const Fq12& o) const { return c == o.c; }
};

Fq12 fq12_one();
Fq12 fq12_mul(const Fq12& a, const Fq12& b);
Fq12 fq12_inv(const Fq12& a);

// Miller loop f_{6x+2,Q}(P) with BN frobenius corrections (no final exp).
Fq12 miller_loop(const G2& q, const G1& p);
Fq12 final_exponentiate(const Fq12& f);

struct VerifyingKey {
  G1 alpha_g1;
  G2 beta_g2, gamma_g2, delta_g2;
  std::vector<G1> ic;
};

struct Proof {
  G1 a, c;
  G2 b;
};

// The product of the verifier's four Miller loops, e(A,B) e(-acc,gamma)
// e(-C,delta) e(-alpha,beta) before the final exponentiation; the proof is
// valid where its final exponentiation is one. publics are plain Fr
// values, one per IC point past the first.
Fq12 groth16_miller_product(const VerifyingKey& vk, const Proof& proof,
                            const std::vector<U256>& publics);

}  // namespace inf
