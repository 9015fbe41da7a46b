"""The ten readers of the program's span log (`harness/spans.py`), on
synthetic runs with a planted log: a window's metric takes only the spans
inside the window (not the warm-up's, nor the check's after it, nor one
across its start) and gives their milliseconds a finished proof; a set-up
metric takes only its spans that end before the window; each gives None
where the ring dropped a span that may have lain in its interval, where
no span has its name, and where the program keeps no span log. On the toy
cell, the prover's four new metrics read what a run of the program
recorded."""

import bench_paths  # noqa: F401  (sys.path for the harness)

from collections import deque

import pytest

from harness import spec, window
from harness.cell import program_prove
from harness.runner import measure
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.utils import profiling
from toy import toy_cell

PER_PROOF = {
    "witness_words_ms": "prove.h_dispatch.words",
    "msm_card_wait_ms": "prove.msm_wait.card",
    "msm_combine_ms": "prove.msm_wait.combine",
    "assembly_ms": "prove.assembly",
    "verify_checks_ms": "verify.checks",
    "verify_product_ms": "verify.product",
    "verify_final_exp_ms": "verify.final_exp",
}
SET_UP = {"circuit_build_s": "setup.circuit", "key_load_s": "setup.key",
          "prewarm_s": "setup.prewarm"}
START, END = 100.0, 110.0


def planted(monkeypatch, found, lost_end=None):
    """The program's log holding `found` (name, start, end) spans."""
    log = deque(maxlen=profiling.RING)
    for i, (name, a, b) in enumerate(found):
        log.append(profiling.Span(name, a, b, i, None, 0, None))
    monkeypatch.setattr(profiling, "_LOG", log)
    monkeypatch.setattr(profiling, "_lost_end", lost_end)


def fake_run(proofs: int = 4, failed: int = 1) -> window.Run:
    records = [window.ProofRecord(index=i, witness=0, seed=i,
                                  start=START + i, ok=i < proofs)
               for i in range(proofs + failed)]
    return window.Run(records, START, END, setup_s=40.0)


def read(metric, run):
    return spec.reader(metric)(run)


def test_every_reader_is_a_metric_of_both_cells():
    bench = spec.load()
    for cell in ("process-backlog.ref", "tally-backlog.largest"):
        names = {m["name"] for m in spec.metrics(bench, cell, True)}
        assert names >= set(PER_PROOF) | set(SET_UP)
    for m in bench["per_layer"]:
        if m["name"] in PER_PROOF or m["name"] in SET_UP:
            assert m["source"] == "program_span"
            assert m["moves"] == ("setup_s" if m["name"] in SET_UP
                                  else "proofs_per_s")


@pytest.mark.parametrize("metric", sorted(PER_PROOF))
def test_window_metric_is_the_mean_over_finished_proofs(metric,
                                                        monkeypatch):
    name = PER_PROOF[metric]
    planted(monkeypatch, [
        (name, 95.0, 95.5),                  # warm-up, before the window
        (name, 99.99, 100.02),               # across the window's start
        (name, 100.1, 100.11), (name, 101.1, 101.12),
        (name, 102.1, 102.13), (name, 103.1, 103.14),
        ("other", 100.2, 100.9),             # another span name
        (name, 104.1, 104.15),               # the failed proof's, inside
        (name, 111.0, 111.5),                # the check, after the window
    ])
    # (10 + 20 + 30 + 40 + 50) ms over 4 finished proofs
    assert read(metric, fake_run()) == pytest.approx(150.0 / 4)


@pytest.mark.parametrize("metric", sorted(SET_UP))
def test_set_up_metric_sums_the_spans_before_the_window(metric,
                                                        monkeypatch):
    name = SET_UP[metric]
    planted(monkeypatch, [
        (name, 10.0, 12.5), (name, 20.0, 21.0),
        ("setup.other", 12.5, 20.0),
        (name, 99.0, 100.5),                 # ends inside the window
        (name, 105.0, 106.0),                # inside the window
    ])
    assert read(metric, fake_run()) == pytest.approx(3.5)


@pytest.mark.parametrize("metric", sorted(PER_PROOF) + sorted(SET_UP))
def test_none_where_the_ring_dropped_a_span_of_the_interval(metric,
                                                            monkeypatch):
    name = {**PER_PROOF, **SET_UP}[metric]
    spans = [(name, 30.0, 31.0), (name, 100.5, 100.6)]
    planted(monkeypatch, spans, lost_end=100.2)
    assert read(metric, fake_run()) is None
    # a drop long before the window leaves a window's metric whole; a
    # set-up metric reads from the start, so it may have lost a span
    planted(monkeypatch, spans, lost_end=1.0)
    value = read(metric, fake_run())
    if metric in SET_UP:
        assert value is None
    else:
        assert value == pytest.approx(100.0 / 4)


@pytest.mark.parametrize("metric", sorted(PER_PROOF) + sorted(SET_UP))
def test_none_where_no_span_has_the_name(metric, monkeypatch):
    planted(monkeypatch, [("prove", 30.0, 31.0), ("prove", 100.5, 101.0)])
    assert read(metric, fake_run()) is None


@pytest.mark.parametrize("metric", ["msm_combine_ms", "key_load_s"])
def test_none_where_the_program_keeps_no_span_log(metric, monkeypatch):
    planted(monkeypatch, [(n, 100.5, 101.0) for n in PER_PROOF.values()]
            + [(n, 1.0, 2.0) for n in SET_UP.values()])
    monkeypatch.delattr(profiling, "spans")
    assert read(metric, fake_run()) is None


def test_window_metric_none_without_a_finished_proof(monkeypatch):
    planted(monkeypatch, [("prove.assembly", 100.5, 101.0)])
    assert read("assembly_ms", fake_run(proofs=0)) is None


def test_toy_cell_reads_the_prover_spans():
    """A run of the program on the toy cell: the prover's metrics read its
    spans, the card's wait and the combine make up `msm_wait` as the
    program's stage trace rounds it, and the conversion lies in
    `h_dispatch`."""
    toy, inputs, _ = toy_cell()
    names = ["witness_words_ms", "msm_card_wait_ms", "msm_combine_ms",
             "assembly_ms", "h_dispatch_ms"]
    readers = {m["name"]: (m, spec.reader(m["name"]))
               for m in spec.load()["per_layer"] if m["name"] in names}
    waits = []

    def prove(dep, witness, rng):
        out = program_prove(dep, witness, rng)
        waits.append(g16.LAST_PROVE_TRACE["msm_wait"])
        return out

    result = measure(toy, inputs, readers, 0.5, 424242424242, 0.0,
                     prove=prove)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == set(names)
    assert result["correct"] is True
    mean_wait = sum(waits) / len(waits) * 1e3
    assert abs(got["msm_card_wait_ms"] + got["msm_combine_ms"]
               - mean_wait) <= 1.0
    assert got["witness_words_ms"] <= got["h_dispatch_ms"]
