"""The port's native verifier on the Fq2/Fq6/Fq12 tower against the
reference's library and the pure-Python pairing.

`inf_groth16_verify` of the port's library (infimum_tpu_torch/native) returns
the reference's library's code (native/, through infimum_tpu.native) on a
good proof, on tampered and malformed ones, and on public inputs out of
range; where the input is well formed, its verdict is the reference's
verify_py's.
`inf_pairing_value` gives the final-exponentiated pairing the verifier
checks: the reference's curve/pairing.py's e(P, Q) (infimum_tpu.curve) to
the power k = 2x(6x^2 + 3x + 1) that the hard part's chain computes, with
gcd(k, r) = 1, and bilinear."""

import ctypes
import math
import random

import pytest
import torch

from infimum_tpu import native as ref_native
from infimum_tpu.curve import pairing
from infimum_tpu.groth16 import groth16 as ref
from infimum_tpu_torch import native
from infimum_tpu_torch.curve.bn254_host import (B2, G1_GEN, G2_GEN, g1_add,
                                                g1_mul, g1_neg, g2_add,
                                                g2_double, g2_is_on_curve,
                                                g2_mul, g2_neg)
from infimum_tpu_torch.ff.bn254 import BN_X, FQ_MOD, FR_MOD
from infimum_tpu_torch.groth16 import groth16 as port
from infimum_tpu_torch.io.arkworks import (serialize_g1, serialize_g2,
                                           serialize_proof, serialize_vkey)

from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PUBLICS = [21, 10]
K = 2 * BN_X * (6 * BN_X ** 2 + 3 * BN_X + 1)

@pytest.fixture(scope="module")
def proof():
    cs, w = _toy_witness()
    pk = port.setup(cs, random.Random(42), device="cpu")
    return pk.vk, port.prove(pk, cs, w, random.Random(43), device="cpu")


def _fq2_sqrt(a):
    """A square root in Fq2 = Fq[u]/(u^2 + 1) (q = 3 mod 4), or None."""
    a0, a1 = a
    s = pow((a0 * a0 + a1 * a1) % FQ_MOD, (FQ_MOD + 1) // 4, FQ_MOD)
    inv2 = pow(2, -1, FQ_MOD)
    for d in ((a0 + s) * inv2 % FQ_MOD, (a0 - s) * inv2 % FQ_MOD):
        x0 = pow(d, (FQ_MOD + 1) // 4, FQ_MOD)
        if x0 and x0 * x0 % FQ_MOD == d:
            x1 = a1 * pow(2 * x0, -1, FQ_MOD) % FQ_MOD
            if ((x0 * x0 - x1 * x1) % FQ_MOD, 2 * x0 * x1 % FQ_MOD) == \
                    (a0 % FQ_MOD, a1 % FQ_MOD):
                return x0, x1
    return None


def _g2_times_r(p):
    """[r]p by double-and-add (g2_mul reduces its scalar mod r)."""
    acc = None
    for bit in bin(FR_MOD)[2:]:
        acc = g2_double(acc)
        if bit == "1":
            acc = g2_add(acc, p)
    return acc


def _g2_outside_subgroup():
    """A point of the twist that is not in the order-r subgroup."""
    for x0 in range(1, 100):
        x = (x0, 1)
        x2 = ((x0 * x0 - 1) % FQ_MOD, 2 * x0 % FQ_MOD)
        x3 = ((x2[0] * x0 - x2[1]) % FQ_MOD, (x2[0] + x2[1] * x0) % FQ_MOD)
        y = _fq2_sqrt(((x3[0] + B2[0]) % FQ_MOD, (x3[1] + B2[1]) % FQ_MOD))
        if y is not None:
            p = (x, y)
            assert g2_is_on_curve(p)
            if _g2_times_r(p) is not None:
                return p
    raise AssertionError("no point found")


def _with(p, **kw):
    return port.Proof(**{"a": p.a, "b": p.b, "c": p.c, **kw})


def _garble(vk_bytes, key, cut):
    """The key point's bytes cut to `cut` and padded back with zeros."""
    b = bytes(vk_bytes[key])
    return {**vk_bytes, key: list(b[:cut] + bytes(len(b) - cut))}


# name -> (proof, key, publics from the good ones; the expected code).
# A case that changes bytes rather than points gives its bytes instead.
CASES = {
    "good": (lambda vk, p: (vk, p, PUBLICS), 1),
    "a_moved": (lambda vk, p: (vk, _with(p, a=g1_add(p.a, G1_GEN)),
                               PUBLICS), 0),
    "b_moved": (lambda vk, p: (vk, _with(p, b=g2_add(p.b, G2_GEN)),
                               PUBLICS), 0),
    "c_moved": (lambda vk, p: (vk, _with(p, c=g1_add(p.c, G1_GEN)),
                               PUBLICS), 0),
    "a_negated": (lambda vk, p: (vk, _with(p, a=g1_neg(p.a)), PUBLICS), 0),
    "b_negated": (lambda vk, p: (vk, _with(p, b=g2_neg(p.b)), PUBLICS), 0),
    "c_negated": (lambda vk, p: (vk, _with(p, c=g1_neg(p.c)), PUBLICS), 0),
    "public0_plus_one": (lambda vk, p: (vk, p, [22, 10]), 0),
    "public1_plus_one": (lambda vk, p: (vk, p, [21, 11]), 0),
    "a_at_infinity": (lambda vk, p: (vk, _with(p, a=None), PUBLICS), 0),
    "c_at_infinity": (lambda vk, p: (vk, _with(p, c=None), PUBLICS), 0),
    "public_above_r": (lambda vk, p: (vk, p, [21 + FR_MOD, 10]), -3),
    "a_off_curve": (lambda vk, p: (vk, _with(
        p, a=(p.a[0], (p.a[1] + 1) % FQ_MOD)), PUBLICS), -2),
    "b_outside_subgroup": (lambda vk, p: (vk, _with(
        p, b=_g2_outside_subgroup()), PUBLICS), -2),
    "key_alpha_truncated": (lambda vk, p: (_garble(
        serialize_vkey(vk), "alpha_g1", 32), p, PUBLICS), -1),
    "key_gamma_garbled": (lambda vk, p: (_garble(
        serialize_vkey(vk), "gamma_g2", 100), p, PUBLICS), -1),
}


def _rc(lib, vk_bytes, proof_bytes, publics):
    ic = b"".join(bytes(p) for p in vk_bytes["gamma_abc_g1"])
    pub = b"".join(int(x).to_bytes(32, "big") for x in publics)
    return lib.inf_groth16_verify(
        bytes(vk_bytes["alpha_g1"]), bytes(vk_bytes["beta_g2"]),
        bytes(vk_bytes["gamma_g2"]), bytes(vk_bytes["delta_g2"]),
        ic, len(vk_bytes["gamma_abc_g1"]),
        bytes(proof_bytes["pi_a"]), bytes(proof_bytes["pi_b"]),
        bytes(proof_bytes["pi_c"]), pub, len(publics))


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_matches_reference_library_and_verify_py(case, proof):
    make, want = CASES[case]
    vk, p, publics = make(*proof)
    vk_bytes = vk if isinstance(vk, dict) else serialize_vkey(vk)
    proof_bytes = serialize_proof(p)
    native._load()
    got = _rc(native._vlib, vk_bytes, proof_bytes, publics)
    assert got == _rc(ref_native._load(), vk_bytes, proof_bytes, publics)
    assert got == want
    if got >= 0:
        assert (got == 1) == ref.verify_py(vk, p, publics)
        assert port.verify(vk, p, publics) == (got == 1)


def _value(p, q):
    """The port's final-exponentiated e(p, q) on curve/pairing.py's basis."""
    native._load()
    out = ctypes.create_string_buffer(32 * 12)
    assert native._vlib.inf_pairing_value(serialize_g1(p), serialize_g2(q),
                                          out) == 0
    return pairing.FQ12([int.from_bytes(out.raw[32 * i: 32 * i + 32], "big")
                         for i in range(12)])


def test_hard_part_power_is_prime_to_r():
    q, x = FQ_MOD, BN_X
    cyc = q ** 4 - q ** 2 + 1
    assert cyc % FR_MOD == 0
    chain = (q ** 3 * (12 * x ** 3 + 6 * x ** 2 + 4 * x - 1)
             + q ** 2 * (12 * x ** 3 + 6 * x ** 2 + 6 * x)
             + q * (12 * x ** 3 + 6 * x ** 2 + 4 * x)
             + (12 * x ** 3 + 12 * x ** 2 + 6 * x + 1))
    assert chain == K * cyc // FR_MOD
    assert math.gcd(K, FR_MOD) == 1


@pytest.mark.parametrize("seed", [None, 7, 2 ** 40 + 9])
def test_pairing_value_is_the_reference_pairing_to_k(seed):
    if seed is None:
        p, q = G1_GEN, G2_GEN
    else:
        rng = random.Random(seed)
        p = g1_mul(G1_GEN, rng.randrange(1, FR_MOD))
        q = g2_mul(G2_GEN, rng.randrange(1, FR_MOD))
    want = pairing.pairing(p, q) ** K
    assert _value(p, q) == want
    assert want != pairing.FQ12.one()


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_pairing_value_is_bilinear(seed):
    rng = random.Random(seed)
    a, b = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
    lhs = _value(g1_mul(G1_GEN, a), g2_mul(G2_GEN, b))
    rhs = _value(g1_neg(g1_mul(G1_GEN, a * b % FR_MOD)), G2_GEN)
    assert lhs * rhs == pairing.FQ12.one()
    assert lhs != pairing.FQ12.one()
    assert _value(G1_GEN, g2_mul(G2_GEN, a)) == _value(g1_mul(G1_GEN, a),
                                                        G2_GEN)
