"""The port's zkey path (infimum_tpu_torch.io.snarkjs, io.snarkjs_json,
groth16.zkey) against the JAX package's on the same inputs.

The .wtns, .r1cs and .zkey bytes of both packages are equal and each reads
the other's; `generate_zkey` on the CPU equals the reference's field by
field on the toy and cubic circuits of tests/test_groth16.py and the
300-product full-width circuit of tests/test_torch_groth16.py; the odd-coset
P rows equal a host computation with the reference's `intt_host` /
`ntt_host`; `prove_zkey` gives the reference's proof bit for bit with the
same seed, which both packages' `verify` accept and which fails both with
a wrong public input or tampered; snarkjs JSON points with z != 1 parse
equally, and an off-curve point fails both. Every comparison is exact."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from infimum_tpu.curve import bn254_host as ref_curve
from infimum_tpu.ff.bn254 import FQ_MOD, FR_MOD
from infimum_tpu.groth16 import groth16 as ref_g16, zkey as ref_zkey
from infimum_tpu.io import snarkjs as ref_io, snarkjs_json as ref_json
from infimum_tpu.ntt.ntt import intt_host, ntt_host
from infimum_tpu_torch.ff.fp import tensor_to_ints
from infimum_tpu_torch.groth16 import groth16 as port_g16, zkey as port_zkey
from infimum_tpu_torch.io import snarkjs as port_io, snarkjs_json as port_json

from test_torch_groth16 import _circuit, _full_width

torch.set_num_threads(1)  # the suite runs in parallel worker processes

P = FR_MOD
SEEDS = {"toy": 2, "cubic": 3, "synthetic": 301}


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module", params=["toy", "cubic", "synthetic"])
def case(request):
    """Circuit, witness, publics and both packages' zkeys from one seed."""
    cs, inputs, publics = _circuit(request.param)
    w = cs.compute_witness(inputs)
    assert cs.check(w)
    seed = SEEDS[request.param]
    return dict(name=request.param, cs=cs, w=w, publics=publics,
                ref=ref_zkey.generate_zkey(cs, random.Random(seed)),
                port=port_zkey.generate_zkey(cs, random.Random(seed),
                                             device="cpu"))


def test_wtns_bytes_match_reference():
    w = [1] + _full_width(5, 37)
    data = port_io.write_wtns(w)
    assert data == ref_io.write_wtns(w)
    assert port_io.read_wtns(data) == ref_io.read_wtns(data) == w


def test_r1cs_bytes_match_reference(case):
    data = port_io.write_r1cs(case["cs"], n_outputs=1)
    assert data == ref_io.write_r1cs(case["cs"], n_outputs=1)
    port_file, ref_file = port_io.read_r1cs(data), ref_io.read_r1cs(data)
    assert _fields(port_file) == _fields(ref_file)
    cs2 = port_file.to_constraint_system()
    assert cs2.check(case["w"])
    bad = list(case["w"])
    bad[-1] = (bad[-1] + 1) % P
    assert not cs2.check(bad)


def test_generate_zkey_matches_reference(case):
    port, ref = case["port"], case["ref"]
    assert _fields(port) == _fields(ref)
    data = port_io.write_zkey(port)
    assert data == ref_io.write_zkey(ref)
    assert _fields(port_io.read_zkey(data)) == _fields(ref)
    assert _fields(ref_io.read_zkey(data)) == _fields(port)
    assert port_zkey.vk_from_zkey(port).__dict__ == \
        ref_zkey.vk_from_zkey(ref).__dict__


def _host_odd_coset(zk, w) -> list[int]:
    """P = A.B - C on the odd coset, from the coefficient triples with
    python ints and the reference's host NTTs."""
    m = zk.domain_size
    ab = [[0] * m, [0] * m]
    for mat, row, sig, val in zk.coeffs:
        ab[mat][row] = (ab[mat][row] + val * w[sig]) % P
    a, b = ab
    c = [x * y % P for x, y in zip(a, b)]
    eta = port_zkey._root_of_unity(2 * m)
    powers = [pow(eta, i, P) for i in range(m)]
    ev = [ntt_host([x * g % P for x, g in zip(intt_host(v), powers)])
          for v in (a, b, c)]
    return [(x * y - z) % P for x, y, z in zip(*ev)]


def test_odd_coset_rows_match_host(case):
    zk = case["port"]
    rows = port_zkey.odd_coset_rows(zk, case["w"], "cpu")
    assert rows.shape == (zk.domain_size, 16)
    assert tensor_to_ints(rows) == _host_odd_coset(zk, case["w"])


def test_port_zkey_proof_verifies(case):
    """The port's prove_zkey on every circuit, through a written and read
    zkey: the port's verify accepts it, and rejects a wrong public input
    and a tampered proof."""
    zk = port_io.read_zkey(port_io.write_zkey(case["port"]))
    proof = port_zkey.prove_zkey(zk, case["w"], random.Random(9),
                                 device="cpu")
    vk, publics = port_zkey.vk_from_zkey(zk), case["publics"]
    assert port_g16.verify(vk, proof, publics)
    assert not port_g16.verify(vk, proof, [publics[0] + 1] + publics[1:])
    tampered = port_g16.Proof(a=ref_curve.g1_add(proof.a, ref_curve.G1_GEN),
                              b=proof.b, c=proof.c)
    assert not port_g16.verify(vk, tampered, publics)


def test_prove_zkey_records_stage_trace():
    """prove_zkey records prove()'s four stages in LAST_PROVE_TRACE."""
    cs, inputs, _ = _circuit("toy")
    zk = port_zkey.generate_zkey(cs, random.Random(SEEDS["toy"]),
                                 device="cpu")
    port_g16.LAST_PROVE_TRACE = {}
    port_zkey.prove_zkey(zk, cs.compute_witness(inputs), random.Random(9),
                         device="cpu")
    assert list(port_g16.LAST_PROVE_TRACE) == [
        "h_dispatch", "witness_limbs", "msm_dispatch", "msm_wait"]
    assert all(v >= 0 for v in port_g16.LAST_PROVE_TRACE.values())


def test_prove_zkey_records_the_prove_spans():
    """prove_zkey records prove()'s spans, nested alike; with no degree
    gate its card wait is the first window sums' read-back."""
    import time

    from infimum_tpu_torch.utils import profiling

    from test_torch_profiling import PROVE_SPANS, _tree

    cs, inputs, _ = _circuit("toy")
    zk = port_zkey.generate_zkey(cs, random.Random(SEEDS["toy"]),
                                 device="cpu")
    t0 = time.perf_counter()
    port_zkey.prove_zkey(zk, cs.compute_witness(inputs), random.Random(9),
                         device="cpu")
    found = profiling.spans(t0, time.perf_counter())
    assert _tree(found) == PROVE_SPANS


@pytest.fixture(scope="module")
def toy_proofs():
    """The toy circuit's proof from both packages' prove_zkey, seed 9."""
    cs, inputs, publics = _circuit("toy")
    w = cs.compute_witness(inputs)
    zk_ref = ref_zkey.generate_zkey(cs, random.Random(SEEDS["toy"]))
    zk_port = port_zkey.generate_zkey(cs, random.Random(SEEDS["toy"]),
                                      device="cpu")
    return dict(
        ref=ref_zkey.prove_zkey(zk_ref, w, random.Random(9)),
        port=port_zkey.prove_zkey(zk_port, w, random.Random(9),
                                  device="cpu"),
        vk_ref=ref_zkey.vk_from_zkey(zk_ref),
        vk_port=port_zkey.vk_from_zkey(zk_port), publics=publics)


def test_prove_zkey_matches_reference(toy_proofs):
    port, ref = toy_proofs["port"], toy_proofs["ref"]
    assert (port.a, port.b, port.c) == (ref.a, ref.b, ref.c)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_both_verifiers_judge_the_zkey_proof(toy_proofs, pkg):
    g16 = port_g16 if pkg == "port" else ref_g16
    vk = toy_proofs[f"vk_{pkg}"]
    proof = toy_proofs["port"]
    proof = g16.Proof(a=proof.a, b=proof.b, c=proof.c)
    publics = toy_proofs["publics"]
    assert g16.verify(vk, proof, publics)
    assert not g16.verify(vk, proof, [publics[0] + 1] + publics[1:])
    tampered = g16.Proof(a=ref_curve.g1_add(proof.a, ref_curve.G1_GEN),
                         b=proof.b, c=proof.c)
    assert not g16.verify(vk, tampered, publics)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["cubic", "synthetic"])
def test_prove_zkey_matches_reference_larger(name):
    cs, inputs, _ = _circuit(name)
    w = cs.compute_witness(inputs)
    zk = port_zkey.generate_zkey(cs, random.Random(SEEDS[name]), device="cpu")
    port = port_zkey.prove_zkey(zk, w, random.Random(9), device="cpu")
    ref = ref_zkey.prove_zkey(
        ref_zkey.generate_zkey(cs, random.Random(SEEDS[name])), w,
        random.Random(9))
    assert (port.a, port.b, port.c) == (ref.a, ref.b, ref.c)


def _projective(seed):
    """snarkjs vk/proof JSON of points with z != 1 (decimal strings)."""
    rng = np.random.default_rng(seed)
    k = [int(x) for x in rng.integers(1, 1 << 62, size=8)]
    g1 = [ref_curve.g1_mul(ref_curve.G1_GEN, x) for x in k[:4]]
    g2 = [ref_curve.g2_mul(ref_curve.G2_GEN, x) for x in k[4:]]
    z1 = k[0] * 7 + 3
    z2 = (k[1] * 5 + 2, k[2] * 3 + 1)

    def j1(p):
        return [str(p[0] * z1 % FQ_MOD), str(p[1] * z1 % FQ_MOD), str(z1)]

    def fq2_mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % FQ_MOD,
                (a[0] * b[1] + a[1] * b[0]) % FQ_MOD)

    def j2(p):
        return [[str(c) for c in fq2_mul(p[0], z2)],
                [str(c) for c in fq2_mul(p[1], z2)], [str(z2[0]), str(z2[1])]]

    vk = {"protocol": "groth16", "vk_alpha_1": j1(g1[0]),
          "vk_beta_2": j2(g2[0]), "vk_gamma_2": j2(g2[1]),
          "vk_delta_2": j2(g2[2]), "IC": [j1(g1[1]), j1(g1[2])]}
    proof = {"pi_a": j1(g1[3]), "pi_b": j2(g2[3]), "pi_c": j1(g1[1])}
    return vk, proof, g1, g2


def test_snarkjs_json_matches_reference():
    vk, proof, g1, g2 = _projective(11)
    for mod in (port_json, ref_json):
        got_vk, got_proof = mod.vk_from_json(vk), mod.proof_from_json(proof)
        assert got_vk.alpha_g1 == g1[0] and got_vk.ic == [g1[1], g1[2]]
        assert (got_vk.beta_g2, got_vk.gamma_g2, got_vk.delta_g2) == \
            tuple(g2[:3])
        assert (got_proof.a, got_proof.b, got_proof.c) == (g1[3], g2[3],
                                                           g1[1])
        assert mod.public_from_json(["5", str(P + 3)]) == [5, 3]
    assert port_json.g1_from_json(["1", "2", "0"]) is None
    assert ref_json.g1_from_json(["1", "2", "0"]) is None


@pytest.mark.parametrize("which", ["g1", "g2"])
def test_snarkjs_json_off_curve_rejected_by_both(which):
    vk, proof, _, _ = _projective(12)
    if which == "g1":
        bad = list(proof["pi_a"])
        bad[1] = str(int(bad[1]) + 1)
    else:
        bad = [list(c) for c in proof["pi_b"]]
        bad[1][0] = str(int(bad[1][0]) + 1)
    for mod in (port_json, ref_json):
        with pytest.raises(AssertionError, match="not on curve"):
            getattr(mod, f"{which}_from_json")(bad)
