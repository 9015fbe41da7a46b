# Copied from infimum_tpu/hash/grain.py; the port keeps its own host layers.
"""Grain-LFSR generation of circom-compatible Poseidon parameters.

Poseidon round constants and MDS matrices are not arbitrary data: they are the
deterministic output of the Grain LFSR procedure from the Poseidon reference
implementation (generate_parameters_grain.sage), with the profile circomlib uses:
GF(p) field tag, x^5 S-box, n=254, widths t=2..13, R_F=8, and the per-width partial
round counts below (reference behavioral spec: pallet/src/hash/parameters.rs:16-19).

We generate them from scratch here and verify against the reference's
light-poseidon / circomlibjs known-answer vectors (pallet/src/tests/poseidon.rs).
Generated parameters are cached at import time per width.
"""

from __future__ import annotations

import functools

from ..ff.bn254 import FR_MOD

# 8 full rounds always; partial rounds per width t = index + 2.
FULL_ROUNDS = 8
PARTIAL_ROUNDS = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64]
MAX_WIDTH = 13  # reference MAX_X5_LEN (pallet/src/hash/poseidon.rs:10)


def _int_to_bits(x: int, width: int) -> list[int]:
    return [(x >> (width - 1 - i)) & 1 for i in range(width)]


class _Grain:
    """The 80-bit Grain LFSR stream used by the Poseidon reference scripts."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254):
        state = (
            _int_to_bits(1, 2)        # field tag: prime field
            + _int_to_bits(0, 4)      # sbox tag: x^alpha
            + _int_to_bits(n, 12)     # field size in bits
            + _int_to_bits(t, 12)     # state width
            + _int_to_bits(r_f, 10)   # full rounds
            + _int_to_bits(r_p, 10)   # partial rounds
            + [1] * 30
        )
        assert len(state) == 80
        self.state = state
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def bit(self) -> int:
        # Decimation: a raw 1-bit means "emit the next raw bit", a raw 0-bit
        # means "discard the next raw bit".
        while True:
            if self._raw_bit() == 1:
                return self._raw_bit()
            self._raw_bit()

    def field_element(self, n: int = 254, modulus: int = FR_MOD) -> int:
        """Rejection-sampled field element (used for the round constants)."""
        while True:
            x = 0
            for _ in range(n):
                x = (x << 1) | self.bit()
            if x < modulus:
                return x

    def field_element_mod(self, n: int = 254, modulus: int = FR_MOD) -> int:
        """Raw n-bit draw reduced mod p (used for the MDS xs/ys in the
        circomlib/light-poseidon profile — no rejection there)."""
        x = 0
        for _ in range(n):
            x = (x << 1) | self.bit()
        return x % modulus


@functools.lru_cache(maxsize=None)
def poseidon_params(t: int) -> tuple[list[int], list[list[int]]]:
    """Round constants (flat, length (R_F+R_P)*t) and t*t MDS matrix for width t."""
    if not 2 <= t <= MAX_WIDTH:
        raise ValueError(f"unsupported poseidon width {t}")
    r_p = PARTIAL_ROUNDS[t - 2]

    g = _Grain(t, FULL_ROUNDS, r_p)
    num_constants = (FULL_ROUNDS + r_p) * t
    ark = [g.field_element() for _ in range(num_constants)]

    # Cauchy MDS sampled from the SAME continuing Grain stream:
    # M[i][j] = 1 / (x_i + y_j) with t xs then t ys drawn after the constants,
    # raw draws reduced mod p (no rejection sampling for the matrix).
    xs = [g.field_element_mod() for _ in range(t)]
    ys = [g.field_element_mod() for _ in range(t)]
    mds = [
        [pow((xs[i] + ys[j]) % FR_MOD, FR_MOD - 2, FR_MOD) for j in range(t)]
        for i in range(t)
    ]
    return ark, mds
