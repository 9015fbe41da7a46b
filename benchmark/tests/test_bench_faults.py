"""The rest of a run (the window, the metrics, the comparison), past the
look for a chip, on the toy cell on the CPU: a sound program comes out
correct, and the control and each fault the cells can have, planted
underneath the timed path, come out not correct: a proof altered where it
is produced, half of an MSM's scalars left out, a verify that accepts what
it must refuse, a circuit other than the one pinned. (Faults that need a
state, a mean over a batch or an exchange between chips do not apply: a
proof keeps no state across batches and runs on one card.)"""

import bench_paths  # noqa: F401  (sys.path for the harness)

import dataclasses

import pytest

from harness import check, spec
from harness.cell import program_prove
from harness.runner import measure
from infimum_tpu_torch.curve.bn254_host import G1_GEN, g1_add
from infimum_tpu_torch.groth16 import groth16 as g16
from toy import toy_cell

READERS = {m["name"]: (m, spec.reader(m["name"]))
           for m in spec.load()["end_to_end"]}


def run(prove=program_prove, copies=1, dep=None):
    toy, inputs, _ = toy_cell(copies=copies)
    return measure(dep or toy, inputs, READERS, 0.001, 424242424242, 0.0,
                   prove=prove)


def test_sound_program_is_correct():
    result = run()
    assert result["correct"] is True
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"proofs_per_s", "proof_p90_s",
                                      "setup_s"}
    assert list(result)[-1] == "compared"
    assert result["compared"] == {k: {"value": 0, "limit": 0}
                                  for k in ("wrong_points", "failed_proofs",
                                            "accepted_bad_proofs",
                                            "circuit_mismatch")}


def test_sound_verify_refuses_both_bad_proofs():
    # witness 0's bad proof moves C, witness 1's a public input
    result = run(copies=2)
    assert result["correct"] is True
    assert result["compared"]["accepted_bad_proofs"]["value"] == 0


def test_control_is_not_correct():
    _, _, ref = toy_cell()
    result = run(check.control_prove(ref, g16.Proof))
    assert result["correct"] is False
    # B reads only x and constants, below the cut: A and C differ
    assert result["compared"]["wrong_points"]["value"] == 2


def test_answer_altered_where_produced(monkeypatch):
    real = g16.prove_queries

    def altered(*a, **k):
        proof = real(*a, **k)
        return g16.Proof(a=proof.a, b=proof.b, c=g1_add(proof.c, G1_GEN))

    monkeypatch.setattr(g16, "prove_queries", altered)
    result = run()
    assert result["correct"] is False
    assert result["compared"]["wrong_points"]["value"] == 1
    assert result["failed"] == 1              # the program's verify agrees


@pytest.mark.parametrize("query", ["a", "h"])
def test_half_the_scalars_left_out(monkeypatch, query):
    real = g16._msm_async

    def halved(key, name, points, scalars, *a):
        if name == query:
            scalars = scalars.clone()
            scalars[scalars.shape[0] // 2:] = 0
        return real(key, name, points, scalars, *a)

    monkeypatch.setattr(g16, "_msm_async", halved)
    result = run()
    assert result["correct"] is False
    assert result["compared"]["wrong_points"]["value"] >= 1


def test_verify_that_accepts_everything(monkeypatch):
    monkeypatch.setattr(g16, "verify", lambda vk, proof, public: True)
    result = run()
    assert result["correct"] is False
    assert result["failed"] == 0 and result["compared"]["wrong_points"][
        "value"] == 0
    assert result["compared"]["accepted_bad_proofs"]["value"] == 1


def test_verify_that_ignores_public_inputs(monkeypatch):
    real = g16.verify
    _, inputs, _ = toy_cell()
    monkeypatch.setattr(g16, "verify", lambda vk, proof, public: real(
        vk, proof, inputs.publics[0]))
    result = run(copies=2)
    assert result["correct"] is False
    assert result["compared"]["accepted_bad_proofs"]["value"] == 1


@pytest.mark.parametrize("key", ["constraints", "rows_sha256"])
def test_circuit_other_than_pinned(key):
    dep, _, _ = toy_cell()
    pinned = dict(dep.config["circuits"]["toy"])
    pinned[key] = "other"
    other = dataclasses.replace(dep, config={**dep.config,
                                             "circuits": {"toy": pinned}})
    result = run(dep=other)
    assert result["correct"] is False
    assert result["compared"]["circuit_mismatch"]["value"] == 1


def test_deploy_refuses_without_the_native_verifier(monkeypatch):
    from harness import cell
    from infimum_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    config = spec.config(spec.load(), "maci-10-2-1-2")
    with pytest.raises(RuntimeError, match="native"):
        cell.deploy(config, spec.traffic("tally-backlog"))
