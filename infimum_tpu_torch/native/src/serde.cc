// Copied from native/src/serde.cc, the reading half only.
#include "serde.h"

namespace inf {
namespace {

// field elements on the wire are plain (non-Montgomery) LE bytes
bool read_fq(const uint8_t* b, U256* out, bool mask_flags) {
  uint8_t tmp[32];
  std::memcpy(tmp, b, 32);
  if (mask_flags) tmp[31] &= 0x3f;
  U256 x = from_le32(tmp);
  if (cmp(x, FQ().mod) >= 0) return false;
  *out = FQ().to_mont(x);
  return true;
}

}  // namespace

bool deserialize_g1(const uint8_t* b, G1* out, bool validate) {
  uint8_t flags = b[63] & 0xc0;
  if (flags & INFINITY_FLAG) {
    *out = G1{};
    return true;
  }
  G1 p;
  p.inf = false;
  if (!read_fq(b, &p.x, false)) return false;
  if (!read_fq(b + 32, &p.y, true)) return false;
  if (validate && !g1_on_curve(p)) return false;
  *out = p;
  return true;
}

bool deserialize_g2(const uint8_t* b, G2* out, bool validate) {
  uint8_t flags = b[127] & 0xc0;
  if (flags & INFINITY_FLAG) {
    *out = G2{};
    return true;
  }
  G2 p;
  p.inf = false;
  if (!read_fq(b, &p.x.c0, false)) return false;
  if (!read_fq(b + 32, &p.x.c1, false)) return false;
  if (!read_fq(b + 64, &p.y.c0, false)) return false;
  if (!read_fq(b + 96, &p.y.c1, true)) return false;
  if (validate) {
    if (!g2_on_curve(p)) return false;
    if (!g2_in_subgroup(p)) return false;
  }
  *out = p;
  return true;
}

}  // namespace inf
