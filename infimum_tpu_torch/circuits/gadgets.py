# Copied from infimum_tpu/circuits/gadgets.py; the port keeps its own host layers.
"""R1CS gadgets for the MACI circuits: Poseidon, Merkle trees, comparators.

Statement-level equivalents of the reference's circom utility templates
(circuits/utils/*.circom): same public-signal and commitment semantics, built
on our own constraint system (groth16/r1cs.py) since we run our own trusted
setup. Poseidon uses the identical circom/grain parameter set (hash/grain.py,
matching pallet/src/hash/parameters.rs), so all hashes are bit-exact with the
reference pallet and circuits.
"""

from __future__ import annotations

from ..ff.bn254 import FR_MOD
from ..hash.grain import poseidon_params, FULL_ROUNDS, PARTIAL_ROUNDS
from ..groth16.r1cs import ConstraintSystem, LC

P = FR_MOD


def sbox5(cs: ConstraintSystem, x: LC) -> LC:
    """x^5 via 3 constraints (x2, x4, x5)."""
    x2 = cs.mul(x, x)
    x4 = cs.mul(x2, x2)
    return cs.mul(x4, x)


def poseidon_perm_gadget(cs: ConstraintSystem, state: list[LC]) -> list[LC]:
    """Circom Poseidon permutation (circuits/utils/poseidon-cipher.circom:164
    PoseidonPerm): ark-add, x^5 S-box (full/partial), MDS mix per round.
    Linear steps are free (folded into LCs); only S-boxes cost constraints."""
    t = len(state)
    ark, mds = poseidon_params(t)
    r_p = PARTIAL_ROUNDS[t - 2]
    half = FULL_ROUNDS // 2
    s = list(state)
    for rnd in range(FULL_ROUNDS + r_p):
        s = [x + LC.const(ark[rnd * t + i]) for i, x in enumerate(s)]
        if rnd < half or rnd >= half + r_p:
            s = [sbox5(cs, x) for x in s]
        else:
            s[0] = sbox5(cs, s[0])
        s = [
            sum((s[j].scale(mds[i][j]) for j in range(t)), LC())
            for i in range(t)
        ]
    return s


def poseidon_gadget(cs: ConstraintSystem, inputs: list[LC]) -> LC:
    """PoseidonHasher(n): perm over [0, inputs...], output element 0
    (circuits/utils/hashers.circom:12-29)."""
    return poseidon_perm_gadget(cs, [LC.const(0)] + list(inputs))[0]


# -- Merkle trees -------------------------------------------------------------

def check_root_binary(cs: ConstraintSystem, leaves: list[LC]) -> LC:
    """CheckRoot(levels): root of a full binary tree over 2^levels leaves
    (circuits/utils/incremental-merkle-tree.circom:79)."""
    level = list(leaves)
    assert len(level) & (len(level) - 1) == 0
    while len(level) > 1:
        level = [
            poseidon_gadget(cs, [level[i], level[i + 1]])
            for i in range(0, len(level), 2)
        ]
    return level[0]


def check_root_quinary(cs: ConstraintSystem, leaves: list[LC]) -> LC:
    """QuinCheckRoot(depth): root of a full arity-5 tree over 5^depth leaves
    (circuits/utils/incremental-quinary-tree.circom:246)."""
    level = list(leaves)
    while len(level) > 1:
        assert len(level) % 5 == 0
        level = [
            poseidon_gadget(cs, level[i : i + 5])
            for i in range(0, len(level), 5)
        ]
    return level[0]


def merkle_inclusion_binary(cs: ConstraintSystem, leaf: LC,
                            path_indices: list[LC],
                            path_elements: list[LC]) -> LC:
    """MerkleTreeInclusionProof(n_levels) with boolean-constrained indices
    (circuits/utils/incremental-merkle-tree.circom:11)."""
    node = leaf
    for idx, sib in zip(path_indices, path_elements):
        cs.assert_bool(idx)
        # left = idx ? sib : node ; right = idx ? node : sib
        left = node + cs.mul(idx, sib - node)
        right = sib + cs.mul(idx, node - sib)
        node = poseidon_gadget(cs, [left, right])
    return node


def generate_path_indices_binary(cs: ConstraintSystem, index: LC,
                                 levels: int) -> list[LC]:
    """MerkleGeneratePathIndices(levels): base-2 digits of index, with
    reconstruction constraint (incremental-merkle-tree.circom:120)."""
    bits = cs.num2bits(index, levels)
    return bits


def bits_lt_const(cs: ConstraintSystem, bits: list[LC], const: int) -> LC:
    """1 iff the little-endian bit vector is < const (bits already boolean).
    MSB-down scan with a running equality prefix (CompConstant equivalent,
    circuits/utils/compconstant.circom)."""
    lt = LC()
    eq = LC.const(1)
    for i in reversed(range(len(bits))):
        cbit = (const >> i) & 1
        if cbit:
            lt = lt + cs.mul(eq, LC.const(1) - bits[i])
            eq = cs.mul(eq, bits[i])
        else:
            eq = cs.mul(eq, LC.const(1) - bits[i])
    return lt


def num2bits_strict(cs: ConstraintSystem, a: LC) -> list[LC]:
    """254-bit decomposition with the canonical-representation (alias) check:
    the bits must encode a value < p (circomlib Num2Bits_strict)."""
    bits = cs.num2bits(a, 254)
    ok = bits_lt_const(cs, bits, P)
    cs.enforce_zero(ok - LC.const(1))
    return bits


# -- comparators (circomlib semantics) ----------------------------------------

def less_than(cs: ConstraintSystem, a: LC, b: LC, nbits: int) -> LC:
    """LessThan(n): 1 if a < b, inputs assumed < 2^n
    (circuits/utils/comparators.circom)."""
    # bits of a + 2^n - b ; output = 1 - bit n
    shifted = a + LC.const(1 << nbits) - b
    bits = cs.num2bits(shifted, nbits + 1)
    return LC.const(1) - bits[nbits]


def less_eq_than(cs: ConstraintSystem, a: LC, b: LC, nbits: int) -> LC:
    """LessEqThan(n) = LessThan(n)(a, b+1)."""
    return less_than(cs, a, b + LC.const(1), nbits)


def is_equal(cs: ConstraintSystem, a: LC, b: LC) -> LC:
    return cs.is_zero(a - b)


def mux1(cs: ConstraintSystem, sel: LC, a: LC, b: LC) -> LC:
    """sel ? b : a (circomlib Mux1: out = (b-a)*s + a)."""
    return a + cs.mul(sel, b - a)


def calculate_total(terms: list[LC]) -> LC:
    """CalculateTotal(n): linear sum, free in R1CS."""
    return sum(terms, LC())
