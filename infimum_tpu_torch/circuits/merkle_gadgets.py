# Copied from infimum_tpu/circuits/merkle_gadgets.py; the port keeps its own host layers.
"""Quinary-tree and dynamic-depth Merkle gadgets for the process circuit.

Statement equivalents of circuits/utils/incremental-quinary-tree.circom
(QuinSelector :32, Splicer :61, QuinTreeInclusionProof :126,
QuinBatchLeavesExists :187, QuinGeneratePathIndices :210) and the
depth-muxed BinaryMerkleRoot (incremental-merkle-tree.circom:163)."""

from __future__ import annotations

from ..ff.bn254 import FR_MOD, fr_inv
from ..groth16.r1cs import ConstraintSystem, LC
from .gadgets import poseidon_gadget, is_equal, calculate_total

P = FR_MOD


def quin_selector(cs: ConstraintSystem, items: list[LC], index: LC) -> LC:
    """items[index]; enforces index < len(items) implicitly via the one-hot
    sum (all eq bits zero would yield 0 — callers range-check index)."""
    total = LC()
    for j, item in enumerate(items):
        eq = is_equal(cs, index, LC.const(j))
        total = total + cs.mul(eq, item)
    return total


def splice(cs: ConstraintSystem, siblings: list[LC], leaf: LC,
           index: LC) -> list[LC]:
    """Insert `leaf` at position `index` among arity-1 siblings (Splicer)."""
    n = len(siblings) + 1
    out = []
    for j in range(n):
        # out[j] = (j < index) ? siblings[j] : (j == index) ? leaf : siblings[j-1]
        is_here = is_equal(cs, index, LC.const(j))
        # shifted sibling choice: sib[j] if j < index else sib[j-1]
        lt = _lt_const_small(cs, index, j, n)
        # lt = 1 when index <= j-1 i.e. j > index
        sib_lo = siblings[j] if j < len(siblings) else LC.const(0)
        sib_hi = siblings[j - 1] if j - 1 >= 0 else LC.const(0)
        sib = sib_lo + cs.mul(lt, sib_hi - sib_lo)
        out.append(sib + cs.mul(is_here, leaf - sib))
    return out


def _lt_const_small(cs: ConstraintSystem, index: LC, j: int, n: int) -> LC:
    """1 iff index < j, for index in [0, n) with tiny n: one-hot sum."""
    total = LC()
    for v in range(min(j, n)):
        total = total + is_equal(cs, index, LC.const(v))
    return total


def quin_inclusion(cs: ConstraintSystem, leaf: LC, path_indices: list[LC],
                   path_elements: list[list[LC]]) -> LC:
    """Root from leaf + per-level (4 siblings, digit index) (QuinTreeInclusionProof)."""
    node = leaf
    for digit, sibs in zip(path_indices, path_elements):
        level = splice(cs, sibs, node, digit)
        node = poseidon_gadget(cs, level)
    return node


def quin_generate_path_indices(cs: ConstraintSystem, index: LC,
                               levels: int) -> list[LC]:
    """Base-5 digits of index with digit range checks + reconstruction
    (QuinGeneratePathIndices)."""
    digits = []
    acc = LC()

    def digit_hint(k):
        return lambda x: (x // (5 ** k)) % 5

    for k in range(levels):
        v = cs.alloc()
        cs.hint(v, digit_hint(k), (index,), op=("digit5", k))
        d = LC.var(v)
        # d in [0, 5): product (d)(d-1)(d-2)(d-3)(d-4) == 0
        prod = d
        for c in range(1, 5):
            prod = cs.mul(prod, d - LC.const(c))
        cs.enforce_zero(prod)
        digits.append(d)
        acc = acc + d.scale(5 ** k)
    cs.enforce_zero(acc - index)
    return digits


def binary_merkle_root_dynamic(cs: ConstraintSystem, leaf: LC, depth: LC,
                               path_indices: list[LC],
                               path_elements: list[LC],
                               max_depth: int) -> LC:
    """Root of a binary tree whose actual depth is the signal `depth`
    (BinaryMerkleRoot, incremental-merkle-tree.circom:163)."""
    from .gadgets import merkle_inclusion_binary

    nodes = [leaf]
    node = leaf
    for i in range(max_depth):
        idx = path_indices[i]
        cs.assert_bool(idx)
        sib = path_elements[i]
        left = node + cs.mul(idx, sib - node)
        right = sib + cs.mul(idx, node - sib)
        node = poseidon_gadget(cs, [left, right])
        nodes.append(node)
    root = LC()
    for i in range(max_depth + 1):
        eq = is_equal(cs, depth, LC.const(i))
        root = root + cs.mul(eq, nodes[i])
    return root
