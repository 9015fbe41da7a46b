# Copied from infimum_tpu/circuits/eddsa_gadget.py; the port keeps its own host layers.
"""EdDSA-Poseidon signature check as a non-enforcing R1CS gadget.

Statement equivalent of the reference's patched circomlib verifier
(circuits/utils/verify-signature.circom:17-82): outputs a 0/1 validity bit
(message-validator.circom needs the bit, not an enforcement):

  valid <=> S < subOrder  AND  Ax != 0  AND  S*B8 == R8 + h*(8*A)
  with h = Poseidon5(R8x, R8y, Ax, Ay, M).
"""

from __future__ import annotations

from ..curve.babyjubjub import SUB_ORDER
from ..groth16.r1cs import ConstraintSystem, LC
from .gadgets import poseidon_gadget, bits_lt_const, num2bits_strict
from .babyjubjub_gadget import (
    edwards_add, edwards_double, scalar_mul_bits, fixed_base_mul_bits,
    point_equal,
)


def eddsa_poseidon_check(cs: ConstraintSystem, pub, sig_r8, sig_s: LC,
                         msg: LC) -> LC:
    """Returns the validity bit (no enforcement).

    Both scalars use canonical (strict) 254-bit decompositions so the prover
    cannot flip the verdict by choosing an aliased representation."""
    s_bits = num2bits_strict(cs, sig_s)
    s_in_range = bits_lt_const(cs, s_bits, SUB_ORDER)

    ax_nonzero = LC.const(1) - cs.is_zero(pub[0])

    h = poseidon_gadget(cs, [sig_r8[0], sig_r8[1], pub[0], pub[1], msg])
    h_bits = num2bits_strict(cs, h)

    # 8*A via three doublings (verify-signature.circom:45-52)
    a8 = edwards_double(cs, pub)
    a8 = edwards_double(cs, a8)
    a8 = edwards_double(cs, a8)

    left = fixed_base_mul_bits(cs, s_bits)
    right = edwards_add(cs, sig_r8, scalar_mul_bits(cs, h_bits, a8))
    points_match = point_equal(cs, left, right)

    return cs.mul(cs.mul(s_in_range, ax_nonzero), points_match)
