# Copied from infimum_tpu/circuits/babyjubjub_gadget.py; the port keeps its own host layers.
"""BabyJubJub R1CS gadgets: twisted-Edwards add, scalar mul, key derivation.

Statement-level equivalents of the reference's circomlib-derived EC templates
(circuits/utils/babyjub.circom, escalarmulany.circom, escalarmulfix.circom):
complete twisted-Edwards addition (a square, d non-square => the affine
formulas have no exceptional cases), bit-decomposed double-and-add scalar
multiplication, and ECDH/pubkey derivation. Division gates are realized as
hinted quotients with multiplicative checks."""

from __future__ import annotations

from ..ff.bn254 import FR_MOD
from ..curve.babyjubjub import A as BJJ_A, D as BJJ_D, BASE8
from ..groth16.r1cs import ConstraintSystem, LC
from .gadgets import mux1

P = FR_MOD


def _div(cs: ConstraintSystem, num: LC, den: LC) -> LC:
    """q with q*den == num (den != 0 — guaranteed by curve completeness)."""
    q = cs.alloc()
    cs.hint(q, lambda n, d: n * pow(d, -1, P) % P if d else 0, (num, den),
            op=("div0", 0))
    cs.enforce(LC.var(q), den, num)
    return LC.var(q)


def edwards_add(cs: ConstraintSystem, p1, p2):
    """(x1,y1)+(x2,y2) on a x^2 + y^2 = 1 + d x^2 y^2 (complete)."""
    x1, y1 = p1
    x2, y2 = p2
    beta = cs.mul(x1, y2)
    gamma = cs.mul(y1, x2)
    tau = cs.mul(beta, gamma)
    num_x = beta + gamma
    den_x = LC.const(1) + tau.scale(BJJ_D)
    num_y = cs.mul(y1, y2) - cs.mul(x1, x2).scale(BJJ_A)
    den_y = LC.const(1) - tau.scale(BJJ_D)
    return _div(cs, num_x, den_x), _div(cs, num_y, den_y)


def edwards_double(cs: ConstraintSystem, p):
    return edwards_add(cs, p, p)


def scalar_mul_bits(cs: ConstraintSystem, bits, point):
    """sum_i bits_i 2^i * point, bits little-endian (already boolean-
    constrained). Double-and-add from the top bit down."""
    acc = (LC.const(0), LC.const(1))  # identity
    for b in reversed(bits):
        acc = edwards_double(cs, acc)
        added = edwards_add(cs, acc, point)
        acc = (mux1(cs, b, acc[0], added[0]), mux1(cs, b, acc[1], added[1]))
    return acc


def scalar_mul(cs: ConstraintSystem, scalar: LC, point, nbits: int = 251):
    bits = cs.num2bits(scalar, nbits)
    return scalar_mul_bits(cs, bits, point)


def fixed_base_mul_bits(cs: ConstraintSystem, bits, base=BASE8):
    """sum bits_i 2^i * base (PrivToPubKey / EscalarMulFix semantics). The
    doubled base points are constants, so each step is one conditional add."""
    from ..curve import babyjubjub as bjj

    acc = (LC.const(0), LC.const(1))
    cur = base
    for b in bits:
        added = edwards_add(cs, acc, (LC.const(cur[0]), LC.const(cur[1])))
        acc = (mux1(cs, b, acc[0], added[0]), mux1(cs, b, acc[1], added[1]))
        cur = bjj.double(cur)
    return acc


def fixed_base_mul(cs: ConstraintSystem, scalar: LC, nbits: int = 251,
                   base=BASE8):
    return fixed_base_mul_bits(cs, cs.num2bits(scalar, nbits), base)


def point_equal(cs: ConstraintSystem, p1, p2) -> LC:
    """1 iff both coordinates match."""
    from .gadgets import is_equal

    ex = is_equal(cs, p1[0], p2[0])
    ey = is_equal(cs, p1[1], p2[1])
    return cs.mul(ex, ey)
