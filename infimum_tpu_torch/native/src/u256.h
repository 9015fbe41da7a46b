// Copied from native/src/u256.h.
// 256-bit unsigned integers + Montgomery modular arithmetic (4x64 CIOS).
//
// The native host-side number engine for the pallet-equivalent library:
// plays the role ark-ff's BigInt/Fp plays for the reference pallet
// (reference: pallet/src/hash/poseidon.rs uses ark-ff Fr; pallet/src/lib.rs
// deserializes ark-bn254 points). Runtime-modulus so Fq and Fr share code.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>

namespace inf {

using u64 = uint64_t;
using u128 = __uint128_t;

struct U256 {
  u64 v[4] = {0, 0, 0, 0};

  bool operator==(const U256& o) const {
    return v[0] == o.v[0] && v[1] == o.v[1] && v[2] == o.v[2] && v[3] == o.v[3];
  }
  bool operator!=(const U256& o) const { return !(*this == o); }
  bool is_zero() const { return !(v[0] | v[1] | v[2] | v[3]); }
  bool bit(int i) const { return (v[i >> 6] >> (i & 63)) & 1; }
  int bit_length() const {
    for (int w = 3; w >= 0; --w)
      if (v[w]) return 64 * w + (64 - __builtin_clzll(v[w]));
    return 0;
  }
};

inline int cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] < b.v[i]) return -1;
    if (a.v[i] > b.v[i]) return 1;
  }
  return 0;
}

// r = a + b, returns carry-out
inline u64 addc(U256& r, const U256& a, const U256& b) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.v[i] + b.v[i];
    r.v[i] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

// r = a - b, returns borrow-out
inline u64 subb(U256& r, const U256& a, const U256& b) {
  u128 br = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - br;
    r.v[i] = (u64)d;
    br = (d >> 64) ? 1 : 0;
  }
  return (u64)br;
}

// big-endian 32-byte conversions (the pallet's HashBytes convention)
inline U256 from_be32(const uint8_t* b) {
  U256 r;
  for (int i = 0; i < 4; ++i) {
    u64 w = 0;
    for (int j = 0; j < 8; ++j) w = (w << 8) | b[(3 - i) * 8 + j];
    r.v[i] = w;
  }
  return r;
}

inline void to_be32(const U256& x, uint8_t* b) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      b[(3 - i) * 8 + j] = (uint8_t)(x.v[i] >> (8 * (7 - j)));
}

// little-endian (arkworks field serialization)
inline U256 from_le32(const uint8_t* b) {
  U256 r;
  for (int i = 0; i < 4; ++i) {
    u64 w = 0;
    for (int j = 7; j >= 0; --j) w = (w << 8) | b[i * 8 + j];
    r.v[i] = w;
  }
  return r;
}

inline void to_le32(const U256& x, uint8_t* b) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) b[i * 8 + j] = (uint8_t)(x.v[i] >> (8 * j));
}

inline U256 from_hex(const char* s) {
  U256 r;
  size_t n = std::strlen(s);
  int nib = 0;
  for (size_t i = 0; i < n; ++i) {
    char c = s[n - 1 - i];
    u64 d = (c >= '0' && c <= '9') ? c - '0'
            : (c >= 'a' && c <= 'f') ? c - 'a' + 10
                                     : c - 'A' + 10;
    r.v[nib >> 4] |= d << (4 * (nib & 15));
    ++nib;
  }
  return r;
}

// Montgomery context with R = 2^256.
struct Mont {
  U256 mod;
  u64 ninv = 0;  // -mod^{-1} mod 2^64
  U256 r2;       // R^2 mod p
  U256 one_m;    // R mod p (Montgomery 1)

  void init(const U256& m) {
    mod = m;
    u64 inv = 1;
    for (int i = 0; i < 63; ++i) inv *= 2 - m.v[0] * inv;  // Newton mod 2^64
    ninv = ~inv + 1;  // = -inv
    // R mod p and R^2 mod p by modular doubling
    U256 x{{1, 0, 0, 0}};
    for (int i = 0; i < 512; ++i) {
      u64 carry = addc(x, x, x);
      if (carry || cmp(x, mod) >= 0) subb(x, x, mod);
      if (i == 255) one_m = x;
    }
    r2 = x;
  }

  U256 add(const U256& a, const U256& b) const {
    U256 r;
    u64 c = addc(r, a, b);
    if (c || cmp(r, mod) >= 0) subb(r, r, mod);
    return r;
  }

  U256 sub(const U256& a, const U256& b) const {
    U256 r;
    if (subb(r, a, b)) addc(r, r, mod);
    return r;
  }

  U256 neg(const U256& a) const {
    if (a.is_zero()) return a;
    U256 r;
    subb(r, mod, a);
    return r;
  }

  // CIOS Montgomery multiply of Montgomery-form operands.
  U256 mul(const U256& a, const U256& b) const {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
      u128 c = 0;
      for (int j = 0; j < 4; ++j) {
        u128 s = (u128)t[j] + (u128)a.v[j] * b.v[i] + c;
        t[j] = (u64)s;
        c = s >> 64;
      }
      u128 s = (u128)t[4] + c;
      t[4] = (u64)s;
      t[5] = (u64)(s >> 64);

      u64 m = t[0] * ninv;
      c = ((u128)t[0] + (u128)m * mod.v[0]) >> 64;
      for (int j = 1; j < 4; ++j) {
        u128 s2 = (u128)t[j] + (u128)m * mod.v[j] + c;
        t[j - 1] = (u64)s2;
        c = s2 >> 64;
      }
      u128 s3 = (u128)t[4] + c;
      t[3] = (u64)s3;
      t[4] = t[5] + (u64)(s3 >> 64);
      t[5] = 0;
    }
    U256 r{{t[0], t[1], t[2], t[3]}};
    if (t[4] || cmp(r, mod) >= 0) subb(r, r, mod);
    return r;
  }

  U256 sqr(const U256& a) const { return mul(a, a); }
  U256 to_mont(const U256& a) const { return mul(a, r2); }
  U256 from_mont(const U256& a) const {
    U256 one{{1, 0, 0, 0}};
    return mul(a, one);
  }

  // a^e (a in Montgomery form, e plain)
  U256 pow(const U256& a, const U256& e) const {
    U256 result = one_m, base = a;
    int n = e.bit_length();
    for (int i = 0; i < n; ++i) {
      if (e.bit(i)) result = mul(result, base);
      base = sqr(base);
    }
    return result;
  }

  U256 inv(const U256& a) const {  // Fermat: a^(p-2)
    U256 e;
    U256 two{{2, 0, 0, 0}};
    subb(e, mod, two);
    return pow(a, e);
  }
};

}  // namespace inf
