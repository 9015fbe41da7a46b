"""The H stage's roofline share (`metrics/h_roofline.py`) on planted runs:
the least time from the counters the program puts on `prove.h_dispatch`
over the H kernels' time in the trace; the yardstick's formulas give the
H stage's bounds the repo's kernel table states (0.3300 ms at the process
circuit's 2^18 with 3,870,593 terms, 0.0187 ms at the tally circuit's 2^14
with 349,797); the metric gives None without counters (a program that
keeps none), without an H kernel in the trace, or untraced. On the toy
cell, a run of the program reads a share."""

import bench_paths  # noqa: F401  (sys.path for the harness)

from collections import deque

import pytest

from harness import h_yardstick, spec, trace, window
from harness.cell import program_prove
from harness.runner import measure
from infimum_tpu_torch.utils import profiling
from toy import toy_cell

START, END = 100.0, 110.0
PROCESS = (1 << 18, 3870593)
TALLY = (1 << 14, 349797)


def planted(monkeypatch, found):
    """The program's log holding `found` (name, start, end, counts)."""
    log = deque(maxlen=profiling.RING)
    for i, (name, a, b, counts) in enumerate(found):
        sp = profiling.Span(name, a, b, i, None, 0, None)
        if counts is not None:
            sp.count(**counts)
        log.append(sp)
    monkeypatch.setattr(profiling, "_LOG", log)
    monkeypatch.setattr(profiling, "_lost_end", None)


def fake_run(kernel_s: float, names=("fr_ntt_tile_kernel",)) -> window.Run:
    events = [trace.Event("kernel", n, START + 1.0, START + 1.0 + kernel_s)
              for n in names]
    events.append(trace.Event("kernel", "msm_accum_kernel", START + 2.0,
                              START + 3.0))
    rec = window.ProofRecord(index=0, witness=0, seed=0, start=START, ok=True)
    return window.Run([rec], START, END, 40.0,
                      trace.Trace(events, START, END))


def read(run):
    return spec.reader("h_roofline")(run)


@pytest.mark.parametrize("shape,bound_ms", [(PROCESS, 0.3300),
                                            (TALLY, 0.0187)])
def test_formulas_give_the_kernel_tables_bounds(shape, bound_ms):
    assert h_yardstick.h_least_s(*shape) * 1e3 == pytest.approx(
        bound_ms, rel=0.02)


def test_transform_products_hand_worked():
    # n = 8: stage 1 has 4 butterflies all with twiddle 1, stage 2 two of
    # 4, stage 3 three of 4 with twiddles not 1: 0 + 2 + 3 = 5
    assert h_yardstick.transform_products(8) == 5
    assert h_yardstick.transform_products(2) == 0


def test_share_is_the_least_time_over_the_kernel_time(monkeypatch):
    # two proofs' H stages in the window at 2^18, one before it (warm-up)
    least = h_yardstick.h_least_s(*PROCESS)
    counts = dict(zip(("domain", "terms"), PROCESS))
    planted(monkeypatch, [
        ("prove.h_dispatch", START - 5.0, START - 4.9, counts),
        ("prove.h_dispatch", START + 1.0, START + 1.1, counts),
        ("prove.msm_dispatch", START + 1.1, START + 1.2, {"h": 5}),
        ("prove.h_dispatch", START + 2.0, START + 2.1, counts)])
    kernel_s = 4 * least
    run = fake_run(kernel_s / 2, ("fr_rows_kernel", "fr_ntt_pass_kernel"))
    assert read(run) == pytest.approx(2 * least / kernel_s * 100)
    assert read(run) == pytest.approx(50.0)


def test_no_counters_reads_none(monkeypatch):
    # the spans of a program that keeps no counters on them
    planted(monkeypatch, [("prove.h_dispatch", START + 1.0, START + 1.1,
                           None)])
    assert read(fake_run(1e-3)) is None
    # one counted, one not: the window's least time is not whole
    planted(monkeypatch, [
        ("prove.h_dispatch", START + 1.0, START + 1.1,
         dict(zip(("domain", "terms"), TALLY))),
        ("prove.h_dispatch", START + 2.0, START + 2.1, None)])
    assert read(fake_run(1e-3)) is None


def test_no_h_kernel_or_no_trace_reads_none(monkeypatch):
    planted(monkeypatch, [("prove.h_dispatch", START + 1.0, START + 1.1,
                           dict(zip(("domain", "terms"), TALLY)))])
    assert read(fake_run(1e-3, names=())) is None
    run = fake_run(1e-3)
    run.trace = None
    assert read(run) is None


def test_no_span_log_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert read(fake_run(1e-3)) is None


def test_toy_run_reads_a_share():
    # the toy cell on the CPU with a planted H kernel: the program's own
    # spans carry the counters the metric reads
    dep, inputs, _ = toy_cell()
    (entry,) = [m for m in spec.load()["per_layer"]
                if m["name"] == "h_roofline"]
    got = {}

    def prove(d, w, rng):
        t0 = profiling.time.perf_counter()
        proof = program_prove(d, w, rng)
        got["least"] = h_yardstick.window_least_s(
            t0, profiling.time.perf_counter())
        return proof

    result = measure(dep, inputs, {}, 0.001, 424242424242, 0.0, prove=prove)
    assert result["correct"] is True
    assert got["least"] > 0
    assert entry["workloads"] == [c["name"] for c in spec.load()["workloads"]]
