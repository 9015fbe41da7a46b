// Copied from native/src/serde.h, the reading half only.
// arkworks-compatible uncompressed BN254 point serialization — the byte
// contract between prover and on-chain verifier (reference:
// pallet/src/lib.rs:784-813 CanonicalDeserialize, produced by inf-lib
// cli/lib/src/lib.rs:101-141). Mirrors infimum_tpu/io/arkworks.py.
#pragma once

#include "pairing.h"

namespace inf {

constexpr uint8_t INFINITY_FLAG = 0x40;

// G1: 64 bytes (x || y, 32-byte LE Fq each, flags in top bits of last byte).
// G2: 128 bytes (x.c0 || x.c1 || y.c0 || y.c1, flags on last byte of y.c1).
// Return false on malformed input (field range, curve, subgroup).
bool deserialize_g1(const uint8_t* b, G1* out, bool validate = true);
bool deserialize_g2(const uint8_t* b, G2* out, bool validate = true);

}  // namespace inf
