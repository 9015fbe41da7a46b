"""Port curve layer (infimum_tpu_torch.curve.proj) against the reference
CurveDev (G1_DEV / G2_DEV) and the host curve (bn254_host).

The cases are those of tests/test_msm.py:20-39 (P+Q, P+P, P+(-P), infinity
on either side, mixed add into infinity), points from a numpy seed. Points
are compared as affine points: projective limbs are not unique."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infimum_tpu.curve.bn254_host import G1_GEN, G2_GEN, g1_mul, g2_mul
from infimum_tpu.curve.proj import G1_DEV as REF_G1, G2_DEV as REF_G2
from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu_torch.curve.proj import G1_DEV, G2_DEV

torch.set_num_threads(1)  # the suite runs in parallel worker processes

CASES = {"g1": (REF_G1, G1_DEV, G1_GEN, g1_mul),
         "g2": (REF_G2, G2_DEV, G2_GEN, g2_mul)}


def _scalars(seed, n):
    return [int(x) % FR_MOD or 1 for x in
            np.random.default_rng(seed).integers(1, 1 << 62, size=n)]


def _enc(curve, pt):
    x, y = curve.encode_affine([pt])[0]
    return (x, y, curve.one((), "cpu"))


def _ref_enc(curve, pt):
    x, y = jnp.asarray(curve.encode_affine([pt]))[0]
    return (x, y, curve.one((1,))[0])


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_complete_add_cases(name):
    ref, port, gen, mul = CASES[name]
    k1, k2 = _scalars(1, 2)
    p, q = mul(gen, k1), mul(gen, k2)
    P, Q = _enc(port, p), _enc(port, q)
    inf = port.infinity((), "cpu")
    assert port.decode_one(port.add(P, Q)) == mul(gen, k1 + k2)
    assert port.decode_one(port.add(P, P)) == mul(gen, 2 * k1)
    assert port.decode_one(port.add(P, port.neg(P))) is None
    assert port.decode_one(port.add(P, inf)) == p
    assert port.decode_one(port.add(inf, Q)) == q
    assert port.decode_one(port.add(inf, inf)) is None
    assert port.decode_one(port.add_mixed(P, Q[:2])) == mul(gen, k1 + k2)
    assert port.decode_one(port.add_mixed(P, P[:2])) == mul(gen, 2 * k1)
    assert port.decode_one(port.add_mixed(inf, Q[:2])) == q
    # the reference's own device ops give the same affine points
    rP, rQ = _ref_enc(ref, p), _ref_enc(ref, q)
    assert ref.decode_one(ref.add(rP, rQ)) == port.decode_one(port.add(P, Q))
    assert (ref.decode_one(ref.add_mixed(rP, rP[:2]))
            == port.decode_one(port.add_mixed(P, P[:2])))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_batched_add_matches_reference_decode(name):
    ref, port, gen, mul = CASES[name]
    ks = _scalars(7, 6)
    pts = [mul(gen, k) for k in ks]
    qs = pts[1:] + pts[:1]
    qs[2] = pts[2]                       # one doubling lane
    a = port.encode_affine(pts)
    b = port.encode_affine(qs)
    one = port.one((len(pts),), "cpu")
    got = port.decode(port.add((a[:, 0], a[:, 1], one), (b[:, 0], b[:, 1], one)))
    ra = jnp.asarray(ref.encode_affine(pts))
    rb = jnp.asarray(ref.encode_affine(qs))
    rone = ref.one((len(pts),))
    want = ref.decode(ref.add((ra[:, 0], ra[:, 1], rone),
                              (rb[:, 0], rb[:, 1], rone)))
    assert got == want == [ref.host_add(x, y) for x, y in zip(pts, qs)]
    negs = port.decode(port.neg((a[:, 0], a[:, 1], one)))
    assert negs == [mul(gen, FR_MOD - k) for k in ks]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_encode_matches_reference(name):
    ref, port, gen, mul = CASES[name]
    pts = [mul(gen, k) for k in _scalars(3, 5)] + [gen]
    got = port.encode_affine(pts)
    assert np.array_equal(got.numpy(),
                          ref.encode_affine(pts).astype(np.int64))
    with pytest.raises(ValueError):
        port.encode_affine([gen, None])
    one = port.one((len(pts),), "cpu")
    assert port.decode((got[:, 0], got[:, 1], one)) == pts


def test_g2_b3_constant_matches_reference():
    """A wrong G2 b3 passes P + Q with distinct points but breaks doubling,
    so check the constant itself and a doubling chain."""
    assert torch.equal(G2_DEV.b3("cpu"),
                       torch.from_numpy(REF_G2._b3_np.astype(np.int64)))
    P = _enc(G2_DEV, G2_GEN)
    acc = P
    for _ in range(5):
        acc = G2_DEV.add(acc, acc)
    assert G2_DEV.decode_one(acc) == g2_mul(G2_GEN, 32)
