"""The port's verify against the reference's pure-Python pairing.

The port's `verify` runs the port's own copy of the native verifier
(infimum_tpu_torch/native), not the reference's library, and accepts a
good proof and rejects a tampered one and a wrong public input, exactly as
the reference's verify_py does on the same key and proof."""

import random

import pytest
import torch

from infimum_tpu.groth16 import groth16 as ref
from infimum_tpu_torch import native
from infimum_tpu_torch.curve.bn254_host import G1_GEN, g1_add
from infimum_tpu_torch.groth16 import groth16 as port

from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def proof():
    cs, w = _toy_witness()
    pk = port.setup(cs, random.Random(42), device="cpu")
    return pk, port.prove(pk, cs, w, random.Random(43), device="cpu")


@pytest.mark.parametrize("case", ["good", "tampered", "wrong_input"])
def test_native_verify_is_the_ports_own_library(case, proof):
    """The native verify runs the port's own copy of the verifier
    (infimum_tpu_torch/native), not the reference's library, and gives
    the reference's verdict."""
    pk, good = proof
    publics = [22, 10] if case == "wrong_input" else [21, 10]
    p = (port.Proof(a=g1_add(good.a, G1_GEN), b=good.b, c=good.c)
         if case == "tampered" else good)
    got = port.verify(pk.vk, p, publics)
    assert native._vlib._name == str(native._VERIFY_PATH)
    assert native._VERIFY_PATH.parent.name == "native"
    assert native._VERIFY_PATH.parents[1].name == "infimum_tpu_torch"
    assert got == ref.verify_py(pk.vk, p, publics)
    assert got == (case == "good")
