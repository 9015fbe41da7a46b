# Copied from infimum_tpu/hash/poseidon_host.py; the port keeps its own host layers.
"""Host (python-int) circom-compatible Poseidon over BN254 Fr.

Behavioral contract (reference: pallet/src/hash/poseidon.rs:162-208):
  - width t = n_inputs + 1, domain tag 0 prepended,
  - per round: add round constants, S-box x^5 (all elements in the 8 full rounds,
    element 0 only in the partial rounds), then MDS mix,
  - output is state[0].

Used for tree building on the host and as the ground truth for the batched
device Poseidon (poseidon.py).
"""

from __future__ import annotations

import os

from ..ff.bn254 import FR_MOD
from .grain import poseidon_params, FULL_ROUNDS, PARTIAL_ROUNDS, MAX_WIDTH

# The C++ twin (native/src/poseidon.cc, golden-tested against this module
# and the circomlibjs KATs) is ~7-11x faster per hash; every host hot loop
# (pallet inserts, event replay, message encrypt, witness inputs) funnels
# through here, so dispatch to it when the library is available.
# INFIMUM_NATIVE_POSEIDON=0 forces the pure-Python path.
_NATIVE = None


def _native():
    global _NATIVE
    if _NATIVE is None:
        if os.environ.get("INFIMUM_NATIVE_POSEIDON", "1") != "1":
            _NATIVE = False
        else:
            from .. import native

            _NATIVE = native if native.available() else False
    return _NATIVE


def poseidon_perm_py(state: list[int]) -> list[int]:
    """Full Poseidon permutation on a width-t state (plain ints mod r).

    Host tree building hashes millions of leaves at production poll sizes
    (hot loop of pallet inserts + replay, reference poll/state.rs:176-225),
    so this is written for CPython speed: x^5 as three multiplies instead
    of pow(), and MDS row sums with a single deferred reduction."""
    t = len(state)
    p = FR_MOD
    ark, mds = poseidon_params(t)
    r_p = PARTIAL_ROUNDS[t - 2]
    half = FULL_ROUNDS // 2
    s = [x % p for x in state]
    k = 0
    for rnd in range(FULL_ROUNDS + r_p):
        full = rnd < half or rnd >= half + r_p
        for i in range(t):
            x = s[i] + ark[k + i]
            if full or i == 0:
                x %= p
                x2 = x * x % p
                x = x2 * x2 % p * x % p
            s[i] = x                    # lazily reduced; mds sum reduces
        k += t
        ns = [0] * t
        for i in range(t):
            row = mds[i]
            acc = 0
            for j in range(t):
                acc += row[j] * s[j]
            ns[i] = acc % p
        s = ns
    return s


def poseidon_perm(state: list[int]) -> list[int]:
    """Full Poseidon permutation; native C++ when available."""
    nat = _native()
    if nat:
        return nat.poseidon_perm([x % FR_MOD for x in state])
    return poseidon_perm_py(state)


def poseidon_py(inputs: list[int]) -> int:
    """Pure-Python hash (ground truth for the native/device twins)."""
    if not 1 <= len(inputs) <= MAX_WIDTH - 1:
        raise ValueError(f"poseidon arity {len(inputs)} unsupported")
    return poseidon_perm_py([0] + list(inputs))[0]


def poseidon(inputs: list[int]) -> int:
    """circom Poseidon hash: domain tag 0, output element 0."""
    if not 1 <= len(inputs) <= MAX_WIDTH - 1:
        raise ValueError(f"poseidon arity {len(inputs)} unsupported")
    nat = _native()
    if nat:
        return nat.poseidon([x % FR_MOD for x in inputs])
    return poseidon_perm_py([0] + list(inputs))[0]


def poseidon2(a: int, b: int) -> int:
    return poseidon([a, b])
