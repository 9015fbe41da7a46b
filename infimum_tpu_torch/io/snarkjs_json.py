# Copied from infimum_tpu/io/snarkjs_json.py; the port keeps its own host layers.
"""snarkjs JSON artifact parsing: vk.json / proof.json decimal-string points.

Replicates the path the reference CLI takes from snarkjs output to curve
points: snarkjs emits projective points as decimal strings ([x, y, z] for
G1, [[x0,x1],[y0,y1],[z0,z1]] for G2), which inf-lib converts via arkworks
(reference cli/lib/src/lib.rs:55-141 bn_to_bytes_be/g1_bn_to_bytes/
g2_bn_to_bytes and cli/src/serialize.ts:48 loadVerifyingKeys). Normalizes
z to get affine, validates curve membership through the host group law.
"""

from __future__ import annotations

from ..ff.bn254 import FQ_MOD
from ..curve.bn254_host import g1_is_on_curve, g2_is_on_curve
from ..groth16.groth16 import Proof, VerifyingKey

Q = FQ_MOD


def _fq(s) -> int:
    return int(s) % Q


def _fq2_inv(a):
    c0, c1 = a
    norm = (c0 * c0 + c1 * c1) % Q
    inv = pow(norm, Q - 2, Q)
    return (c0 * inv % Q, (Q - c1) * inv % Q)


def _fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q,
            (a[0] * b[1] + a[1] * b[0]) % Q)


def g1_from_json(coords) -> tuple[int, int] | None:
    """[x, y, z] decimal strings (projective; z=0 => infinity) -> affine."""
    x, y, z = (_fq(c) for c in coords)
    if z == 0:
        return None
    if z != 1:
        zi = pow(z, Q - 2, Q)
        x, y = x * zi % Q, y * zi % Q
    p = (x, y)
    assert g1_is_on_curve(p), "g1 point not on curve"
    return p


def g2_from_json(coords) -> tuple | None:
    """[[x0,x1],[y0,y1],[z0,z1]] decimal strings -> affine Fq2 pair."""
    (x, y, z) = (tuple(_fq(c) for c in pair) for pair in coords)
    if z == (0, 0):
        return None
    if z != (1, 0):
        zi = _fq2_inv(z)
        x, y = _fq2_mul(x, zi), _fq2_mul(y, zi)
    p = (x, y)
    assert g2_is_on_curve(p), "g2 point not on curve"
    return p


def vk_from_json(vk: dict) -> VerifyingKey:
    """snarkjs vk.json (vk_alpha_1, vk_beta_2, vk_gamma_2, vk_delta_2, IC)
    -> VerifyingKey, the structure serialize.ts:48 feeds the pallet."""
    assert vk.get("protocol", "groth16") == "groth16"
    return VerifyingKey(
        alpha_g1=g1_from_json(vk["vk_alpha_1"]),
        beta_g2=g2_from_json(vk["vk_beta_2"]),
        gamma_g2=g2_from_json(vk["vk_gamma_2"]),
        delta_g2=g2_from_json(vk["vk_delta_2"]),
        ic=[g1_from_json(p) for p in vk["IC"]],
    )


def proof_from_json(pf: dict) -> Proof:
    """snarkjs proof.json (pi_a, pi_b, pi_c projective decimal strings)."""
    return Proof(a=g1_from_json(pf["pi_a"]),
                 b=g2_from_json(pf["pi_b"]),
                 c=g1_from_json(pf["pi_c"]))


def public_from_json(pub: list) -> list[int]:
    """snarkjs public.json: decimal-string Fr values."""
    from ..ff.bn254 import FR_MOD

    return [int(s) % FR_MOD for s in pub]
