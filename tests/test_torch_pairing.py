"""The port's pure-Python pairing fallback (verify_py on curve/pairing.py)
against the reference's.

With `native.available` patched to false, the port's `verify` takes
verify_py, which accepts a good proof and rejects a tampered one and a
wrong public input, exactly as the reference's verify_py does on the same
key and proof; prepare_inputs and the multi-pairing agree with the
reference's. With it loaded, the native verify is the port's own
library's and gives the same verdicts."""

import random

import pytest
import torch

from infimum_tpu.curve import pairing as ref_pairing
from infimum_tpu.groth16 import groth16 as ref
from infimum_tpu_torch import native
from infimum_tpu_torch.curve import pairing
from infimum_tpu_torch.curve.bn254_host import G1_GEN, G2_GEN, g1_add, g1_neg
from infimum_tpu_torch.groth16 import groth16 as port

from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def proof():
    cs, w = _toy_witness()
    pk = port.setup(cs, random.Random(42), device="cpu")
    return pk, port.prove(pk, cs, w, random.Random(43), device="cpu")


@pytest.mark.parametrize("case", ["good", "tampered", "wrong_input"])
def test_verify_falls_back_to_verify_py(case, proof, monkeypatch):
    pk, good = proof
    publics = [22, 10] if case == "wrong_input" else [21, 10]
    p = (port.Proof(a=g1_add(good.a, G1_GEN), b=good.b, c=good.c)
         if case == "tampered" else good)
    monkeypatch.setattr(native, "available", lambda: False)
    got = port.verify(pk.vk, p, publics)
    assert got == ref.verify_py(pk.vk, p, publics)
    assert got == (case == "good")


@pytest.mark.parametrize("case", ["good", "tampered", "wrong_input"])
def test_native_verify_is_the_ports_own_library(case, proof):
    """The native verify runs the port's own copy of the verifier
    (infimum_tpu_torch/native), not the reference's library, and gives
    the reference's verdict."""
    if not native.available():
        pytest.skip("the native library does not load (no compiler?)")
    pk, good = proof
    publics = [22, 10] if case == "wrong_input" else [21, 10]
    p = (port.Proof(a=g1_add(good.a, G1_GEN), b=good.b, c=good.c)
         if case == "tampered" else good)
    assert native._vlib._name == str(native._VERIFY_PATH)
    assert native._VERIFY_PATH.parent.name == "native"
    assert native._VERIFY_PATH.parents[1].name == "infimum_tpu_torch"
    got = port.verify(pk.vk, p, publics)
    assert got == ref.verify_py(pk.vk, p, publics)
    assert got == (case == "good")


def test_prepare_inputs_matches_reference(proof):
    pk, _ = proof
    for publics in ([21, 10], [0, 0], [2 ** 250 + 7, 3]):
        assert port.prepare_inputs(pk.vk, publics) == \
            ref.prepare_inputs(pk.vk, publics)


def test_multi_pairing_matches_reference():
    pairs = [(G1_GEN, G2_GEN), (g1_neg(G1_GEN), G2_GEN)]
    assert pairing.multi_pairing_is_one(pairs)
    assert ref_pairing.multi_pairing_is_one(pairs)
    assert not pairing.multi_pairing_is_one(pairs[:1])
