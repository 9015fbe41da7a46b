# Copied from infimum_tpu/tree/zeros.py; the port keeps its own host layers.
"""Zero-subtree hash tables for the amortized Merkle trees.

The reference hardcodes these tables (pallet/src/poll/zeroes.rs); here they are
derived from their nothing-up-my-sleeve seeds and the Poseidon chain, and the
derivation is verified against the reference byte tables in tests.

  - binary zero leaf  = MACI "blank state leaf" = Poseidon4(PAD_KEY.x, PAD_KEY.y, 0, 0)
  - quinary zero leaf = keccak256("Maci") mod r  (MACI NOTHING_UP_MY_SLEEVE)
  - zeros[d+1] = Poseidon_arity(zeros[d], ..., zeros[d])
  - EMPTY_BALLOT_ROOTS[i] = depth-10 binary root with every leaf
      Poseidon2(0, quinary-zero-root at vote-option depth i+1)
"""

from __future__ import annotations

import functools

from ..hash.poseidon_host import poseidon

# MACI's padding public key (a fixed BabyJubJub point with unknown private key).
PAD_KEY_X = 10457101036533406547632367118273992217979173478358440826365724437999023779287
PAD_KEY_Y = 19824078218392094440610104313265183977899662750282163392862422243483260492317

# keccak256("Maci") mod r.
NOTHING_UP_MY_SLEEVE = (
    8370432830353022751713833565135785980866757267633941821328460903436894336785
)

STATE_TREE_DEPTH = 10
MAX_ZERO_DEPTH = 33


@functools.lru_cache(maxsize=None)
def blank_state_leaf() -> int:
    return poseidon([PAD_KEY_X, PAD_KEY_Y, 0, 0])


@functools.lru_cache(maxsize=None)
def merkle_zeros(arity: int) -> list[int]:
    """zeros[d] = hash of the all-empty subtree of depth d (33 entries)."""
    zero = blank_state_leaf() if arity == 2 else NOTHING_UP_MY_SLEEVE
    out = [zero]
    for _ in range(MAX_ZERO_DEPTH - 1):
        out.append(poseidon([out[-1]] * arity))
    return out


@functools.lru_cache(maxsize=None)
def quinary_zero_root(depth: int) -> int:
    """Root of the depth-d quinary tree with all leaves = 0 (vote tree zeros)."""
    v = 0
    for _ in range(depth):
        v = poseidon([v] * 5)
    return v


@functools.lru_cache(maxsize=None)
def empty_ballot_root(index: int) -> int:
    """reference: pallet/src/poll/zeroes.rs:73-79 EMPTY_BALLOT_ROOTS[index].

    index i corresponds to vote_option_tree_depth = i + 1.
    """
    ballot = poseidon([0, quinary_zero_root(index + 1)])
    node = ballot
    for _ in range(STATE_TREE_DEPTH):
        node = poseidon([node, node])
    return node
