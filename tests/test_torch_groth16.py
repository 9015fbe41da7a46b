"""The port's Groth16 slice (infimum_tpu_torch.groth16) against the reference.

On the toy and cubic circuits of tests/test_groth16.py and a synthetic
circuit of about 300 constraints with a full-width witness (from a numpy
seed): the port's setup equals the reference's field for field, its prove
equals the reference's bit for bit with the same key and rng, its row
evaluation and H equal eval_rows_device and compute_h_host, the
reference verify accepts its proofs and rejects a wrong public input and a
tampered proof, and keys carried over from the reference prove the same
proof. The reference prove takes its host H path here
(INFIMUM_HOST_H_THRESHOLD=0), so no XLA graph is compiled for it."""

import random

import numpy as np
import pytest
import torch

from infimum_tpu.curve.bn254_host import G1_GEN, g1_add
from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.groth16 import groth16 as ref
from infimum_tpu.groth16.r1cs import ConstraintSystem, LC
from infimum_tpu.groth16.rowval import eval_rows_device, SparseRows as RefRows
from infimum_tpu_torch.groth16 import groth16 as port
from infimum_tpu_torch.groth16.keys import from_reference, load_npz
from infimum_tpu_torch.groth16.rowval import eval_rows

from test_groth16 import _cubic_circuit, _toy_circuit

torch.set_num_threads(1)  # the suite runs in parallel worker processes

P = FR_MOD
PK_FIELDS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
             "a_query", "b_g1_query", "b_g2_query", "l_query", "h_query")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "ic")


def _full_width(seed, n):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]


def _synthetic(n=300):
    """out = x * prod_i (x + k_i) over n multiplications, full-width k_i."""
    ks = _full_width(77, n + 1)
    cs = ConstraintSystem()
    out = cs.alloc_public()
    x = cs.alloc()
    acc = LC.var(x)
    for k in ks[:n]:
        acc = cs.mul(acc, LC.var(x) + LC.const(k))
    cs.enforce_zero(acc - LC.var(out))
    xv = ks[n]
    v = xv
    for k in ks[:n]:
        v = v * (xv + k) % P
    return cs, {out: v, x: xv}, [v]


def _circuit(name):
    if name == "toy":
        cs, prod, total, x, y = _toy_circuit()
        return cs, {prod: 21, total: 10, x: 3, y: 7}, [21, 10]
    if name == "cubic":
        cs, out, x = _cubic_circuit()
        xv = 47
        pub = (xv ** 3 + xv + 5) % P
        return cs, {out: pub, x: xv}, [pub]
    return _synthetic()


@pytest.fixture(scope="module", params=["toy", "cubic", "synthetic"])
def case(request):
    cs, inputs, publics = _circuit(request.param)
    w = cs.compute_witness(inputs)
    assert cs.check(w)
    seed = {"toy": 42, "cubic": 7, "synthetic": 300}[request.param]
    pk_ref = ref.setup(cs, random.Random(seed))
    pk_port = port.setup(cs, random.Random(seed))
    return cs, w, publics, seed, pk_ref, pk_port


def test_setup_matches_reference(case):
    _, _, _, _, pk_ref, pk_port = case
    for f in PK_FIELDS:
        assert getattr(pk_port, f) == getattr(pk_ref, f), f
    for f in VK_FIELDS:
        assert getattr(pk_port.vk, f) == getattr(pk_ref.vk, f), f


def test_prove_matches_reference_and_verifies(case, monkeypatch):
    monkeypatch.setenv("INFIMUM_HOST_H_THRESHOLD", "0")
    cs, w, publics, seed, pk_ref, pk_port = case
    want = ref.prove(pk_ref, cs, w, random.Random(seed + 1))
    got = port.prove(pk_port, cs, w, random.Random(seed + 1))
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert ref.verify(pk_ref.vk, got, publics)
    assert port.verify(pk_port.vk, got, publics)
    wrong = [publics[0] + 1] + publics[1:]
    assert not ref.verify(pk_ref.vk, got, wrong)
    assert not port.verify(pk_port.vk, got, wrong)
    tampered = port.Proof(a=g1_add(got.a, G1_GEN), b=got.b, c=got.c)
    assert not ref.verify(pk_ref.vk, tampered, publics)
    assert not port.verify(pk_port.vk, tampered, publics)


def test_rows_and_h_match_reference(case):
    cs, w, _, _, _, _ = case
    m = ref._domain_size(cs)
    rows = ref._qap_rows(cs)
    want = eval_rows_device(RefRows(rows, len(rows)), w, m)
    got = eval_rows(port.sparse_rows(cs, "cpu"), w, m)
    for g, r in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))
    assert port.compute_h(cs, w) == ref.compute_h_host(cs, w)


def test_reference_keys_prove_the_same_proof(case, tmp_path, monkeypatch):
    from infimum_tpu.groth16.pkcache import save_pk

    monkeypatch.setenv("INFIMUM_HOST_H_THRESHOLD", "0")
    cs, w, publics, seed, pk_ref, _ = case
    carried = from_reference(pk_ref)
    path = str(tmp_path / "pk.npz")
    save_pk(pk_ref, path)
    loaded = load_npz(path)
    for f in PK_FIELDS:
        assert getattr(carried, f) == getattr(pk_ref, f)
        assert getattr(loaded, f) == getattr(pk_ref, f)
    assert loaded.vk == carried.vk
    got = port.prove(loaded, cs, w, random.Random(seed + 2))
    want = ref.prove(pk_ref, cs, w, random.Random(seed + 2))
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
