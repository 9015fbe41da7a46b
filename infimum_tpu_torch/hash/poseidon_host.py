# Copied from infimum_tpu/hash/poseidon_host.py; the port keeps its own host layers.
"""Host circom-compatible Poseidon over BN254 Fr: native C++, and its
python-int twin (`poseidon_py`, `poseidon_perm_py`).

Behavioral contract (reference: pallet/src/hash/poseidon.rs:162-208):
  - width t = n_inputs + 1, domain tag 0 prepended,
  - per round: add round constants, S-box x^5 (all elements in the 8 full rounds,
    element 0 only in the partial rounds), then MDS mix,
  - output is state[0].

Used for tree building on the host and as the ground truth for the batched
device Poseidon (poseidon.py).
"""

from __future__ import annotations

from .. import native
from ..ff.bn254 import FR_MOD
from .grain import poseidon_params, FULL_ROUNDS, PARTIAL_ROUNDS, MAX_WIDTH

# `poseidon` and `poseidon_perm` run the C++ twin (native/src/poseidon.cc,
# golden-tested against the Python below and the circomlibjs KATs), ~7-11x
# faster per hash: every host hot loop (pallet inserts, event replay,
# message encrypt, witness inputs) funnels through here.


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
    """Full Poseidon permutation, in native C++."""
    return native.poseidon_perm([x % FR_MOD for x in state])


def poseidon_py(inputs: list[int]) -> int:
    """Pure-Python hash (ground truth for the native/device twins)."""
    if not 1 <= len(inputs) <= MAX_WIDTH - 1:
        raise ValueError(f"poseidon arity {len(inputs)} unsupported")
    return poseidon_perm_py([0] + list(inputs))[0]


def poseidon(inputs: list[int]) -> int:
    """circom Poseidon hash: domain tag 0, output element 0."""
    if not 1 <= len(inputs) <= MAX_WIDTH - 1:
        raise ValueError(f"poseidon arity {len(inputs)} unsupported")
    return native.poseidon([x % FR_MOD for x in inputs])


def poseidon2(a: int, b: int) -> int:
    return poseidon([a, b])
