# Copied from infimum_tpu/io/arkworks.py; the port keeps its own host layers.
"""arkworks-compatible BN254 point serialization (ark-serialize 0.4).

This is the byte contract between the prover and the on-chain verifier:
the reference pallet deserializes proofs/vkeys with
`CanonicalDeserialize::deserialize_uncompressed` (pallet/src/lib.rs:784-813),
and inf-lib produces those bytes from snarkjs bignum JSON
(cli/lib/src/lib.rs:101-141). Format, per ark-serialize for short-Weierstrass
affine points, uncompressed mode:

  G1: x || y, each 32-byte little-endian Fq; flags live in the top bits of
      the final byte (of y): bit6 = infinity (with x = y = 0).
  G2: x || y, each an Fq2 serialized c0 || c1 (32B LE each); flags on the
      final byte of y.c1.

Deserialization validates: field ranges, curve membership, and (for G2) the
r-torsion subgroup check, matching arkworks `Validate::Yes`.
"""

from __future__ import annotations

from ..ff.bn254 import FQ_MOD, FR_MOD
from ..curve.bn254_host import (
    g1_is_on_curve, g2_is_on_curve, g2_mul_fast,
)

INFINITY_FLAG = 0x40
YNEG_FLAG = 0x80


class SerializationError(ValueError):
    pass


def _fq_to_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, "little")


def _fq_from_bytes(b: bytes, mask_flags: bool = False) -> int:
    v = int.from_bytes(b, "little")
    if mask_flags:
        v &= (1 << 254) - 1  # clear the two flag bits
    if v >= FQ_MOD:
        raise SerializationError("field element out of range")
    return v


def _fq_is_positive(y: int) -> bool:
    """arkworks SWFlags::from_y_coordinate: y > -y in the canonical ordering."""
    return y > (FQ_MOD - y) % FQ_MOD


def _fq2_is_positive(y) -> bool:
    """Fq2 ordering in ark-ff compares c1 first, then c0."""
    c0, c1 = y
    n0, n1 = (FQ_MOD - c0) % FQ_MOD, (FQ_MOD - c1) % FQ_MOD
    return (c1, c0) > (n1, n0)


def serialize_g1(p) -> bytes:
    if p is None:
        return bytes(63) + bytes([INFINITY_FLAG])
    x, y = p
    out = bytearray(_fq_to_bytes(x) + _fq_to_bytes(y))
    if _fq_is_positive(y):
        out[63] |= YNEG_FLAG
    return bytes(out)


def deserialize_g1(b: bytes, validate: bool = True):
    if len(b) != 64:
        raise SerializationError("G1 uncompressed must be 64 bytes")
    flags = b[63] & 0xC0
    if flags & INFINITY_FLAG:
        return None
    x = _fq_from_bytes(b[:32])
    y = _fq_from_bytes(b[32:64], mask_flags=True)
    p = (x, y)
    if validate and not g1_is_on_curve(p):
        raise SerializationError("G1 point not on curve")
    return p


def serialize_g2(p) -> bytes:
    if p is None:
        return bytes(127) + bytes([INFINITY_FLAG])
    (x0, x1), (y0, y1) = p
    out = bytearray(_fq_to_bytes(x0) + _fq_to_bytes(x1)
                    + _fq_to_bytes(y0) + _fq_to_bytes(y1))
    if _fq2_is_positive((y0, y1)):
        out[127] |= YNEG_FLAG
    return bytes(out)


def deserialize_g2(b: bytes, validate: bool = True):
    if len(b) != 128:
        raise SerializationError("G2 uncompressed must be 128 bytes")
    flags = b[127] & 0xC0
    if flags & INFINITY_FLAG:
        return None
    x = (_fq_from_bytes(b[:32]), _fq_from_bytes(b[32:64]))
    y = (_fq_from_bytes(b[64:96]), _fq_from_bytes(b[96:128], mask_flags=True))
    p = (x, y)
    if validate:
        if not g2_is_on_curve(p):
            raise SerializationError("G2 point not on curve")
        if g2_mul_fast(p, FR_MOD) is not None:
            raise SerializationError("G2 point not in r-torsion subgroup")
    return p


# -- pallet-shaped containers (VerifyKey / ProofData byte vectors) ------------

def deserialize_vkey(vk_bytes: dict):
    """pallet VerifyKey {alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1}
    (byte vectors) -> groth16.VerifyingKey."""
    from ..groth16.groth16 import VerifyingKey

    return VerifyingKey(
        alpha_g1=deserialize_g1(bytes(vk_bytes["alpha_g1"])),
        beta_g2=deserialize_g2(bytes(vk_bytes["beta_g2"])),
        gamma_g2=deserialize_g2(bytes(vk_bytes["gamma_g2"])),
        delta_g2=deserialize_g2(bytes(vk_bytes["delta_g2"])),
        ic=[deserialize_g1(bytes(b)) for b in vk_bytes["gamma_abc_g1"]],
    )


def serialize_vkey(vk) -> dict:
    return {
        "alpha_g1": list(serialize_g1(vk.alpha_g1)),
        "beta_g2": list(serialize_g2(vk.beta_g2)),
        "gamma_g2": list(serialize_g2(vk.gamma_g2)),
        "delta_g2": list(serialize_g2(vk.delta_g2)),
        "gamma_abc_g1": [list(serialize_g1(p)) for p in vk.ic],
    }


def deserialize_proof(proof_bytes: dict):
    """pallet ProofData {pi_a, pi_b, pi_c} byte vectors -> groth16.Proof."""
    from ..groth16.groth16 import Proof

    return Proof(
        a=deserialize_g1(bytes(proof_bytes["pi_a"])),
        b=deserialize_g2(bytes(proof_bytes["pi_b"])),
        c=deserialize_g1(bytes(proof_bytes["pi_c"])),
    )


def serialize_proof(proof) -> dict:
    return {
        "pi_a": list(serialize_g1(proof.a)),
        "pi_b": list(serialize_g2(proof.b)),
        "pi_c": list(serialize_g1(proof.c)),
    }


# -- Fr/commitment byte conventions (pallet HashBytes are 32-byte BE) ---------

def fr_from_hash_bytes(b) -> int:
    v = int.from_bytes(bytes(b), "big")
    if v >= FR_MOD:
        raise SerializationError("commitment not a canonical Fr element")
    return v


def fr_to_hash_bytes(x: int) -> bytes:
    return int(x % FR_MOD).to_bytes(32, "big")
