// C ABI of the port's Groth16 verifier (consumed via ctypes from
// infimum_tpu_torch/native): the byte contract of native/src/c_api.cc's
// inf_groth16_verify, with the call's phase boundaries kept for the caller.
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

#include "pairing.h"
#include "serde.h"

using namespace inf;

namespace {

// The phase boundaries of this thread's last inf_groth16_verify, in
// CLOCK_MONOTONIC nanoseconds: its start, then the end of the checks (every
// point read and checked, the public inputs' range), of the Miller product
// (the IC combination and the multi-Miller loop over the four pairs) and of
// the final exponentiation; 0 for a boundary the call did not reach.
thread_local int64_t verify_phases[4];

int64_t monotonic_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// 0, or the call's negative return code on malformed input.
int read_inputs(const uint8_t* vk_alpha, const uint8_t* vk_beta,
                const uint8_t* vk_gamma, const uint8_t* vk_delta,
                const uint8_t* vk_ic, int n_ic, const uint8_t* proof_a,
                const uint8_t* proof_b, const uint8_t* proof_c,
                const uint8_t* publics, int n_pub, VerifyingKey* vk,
                Proof* pr, std::vector<U256>* pub) {
  if (!deserialize_g1(vk_alpha, &vk->alpha_g1)) return -1;
  if (!deserialize_g2(vk_beta, &vk->beta_g2)) return -1;
  if (!deserialize_g2(vk_gamma, &vk->gamma_g2)) return -1;
  if (!deserialize_g2(vk_delta, &vk->delta_g2)) return -1;
  vk->ic.resize(n_ic);
  for (int i = 0; i < n_ic; ++i)
    if (!deserialize_g1(vk_ic + 64 * i, &vk->ic[i])) return -1;
  if (!deserialize_g1(proof_a, &pr->a)) return -2;
  if (!deserialize_g2(proof_b, &pr->b)) return -2;
  if (!deserialize_g1(proof_c, &pr->c)) return -2;
  pub->resize(n_pub);
  for (int i = 0; i < n_pub; ++i) {
    (*pub)[i] = from_be32(publics + 32 * i);
    if (cmp((*pub)[i], FR().mod) >= 0) return -3;
  }
  return 0;
}

}  // namespace

extern "C" {

// vk: alpha(64) beta(128) gamma(128) delta(128) ic(n_ic*64)
// proof: a(64) b(128) c(64); publics: n_pub * 32B BE Fr.
// returns 1 = valid, 0 = invalid, negative = malformed input.
int inf_groth16_verify(const uint8_t* vk_alpha, const uint8_t* vk_beta,
                       const uint8_t* vk_gamma, const uint8_t* vk_delta,
                       const uint8_t* vk_ic, int n_ic, const uint8_t* proof_a,
                       const uint8_t* proof_b, const uint8_t* proof_c,
                       const uint8_t* publics, int n_pub) {
  int64_t* t = verify_phases;
  t[0] = monotonic_ns();
  t[1] = t[2] = t[3] = 0;
  VerifyingKey vk;
  Proof pr;
  std::vector<U256> pub;
  int rc = read_inputs(vk_alpha, vk_beta, vk_gamma, vk_delta, vk_ic, n_ic,
                       proof_a, proof_b, proof_c, publics, n_pub, &vk, &pr,
                       &pub);
  t[1] = monotonic_ns();
  if (rc != 0) return rc;
  if (pub.size() + 1 != vk.ic.size()) return 0;
  Fq12 f = groth16_miller_product(vk, pr, pub);
  t[2] = monotonic_ns();
  bool ok = final_exponentiate(f) == fq12_one();
  t[3] = monotonic_ns();
  return ok ? 1 : 0;
}

void inf_verify_last_phases(int64_t out[4]) {
  std::memcpy(out, verify_phases, sizeof(verify_phases));
}

// For tests: e(P, Q) final-exponentiated as inf_groth16_verify's check does
// it (pairing.h's power of the pairing), written as the 12 coefficients of
// infimum_tpu/curve/pairing.py's polynomial basis, 32-byte big-endian
// standard form, lowest power first. g1: 64 bytes, g2: 128 bytes, both read
// and checked as the verifier reads them; returns 0, or -1 on a malformed
// point.
int inf_pairing_value(const uint8_t* g1, const uint8_t* g2, uint8_t* out) {
  G1 p;
  G2 q;
  if (!deserialize_g1(g1, &p) || !deserialize_g2(g2, &q)) return -1;
  U256 c[12];
  fq12_to_poly(final_exponentiate(multi_miller_loop({{p, q}})), c);
  for (int i = 0; i < 12; ++i) to_be32(c[i], out + 32 * i);
  return 0;
}

}  // extern "C"
