"""The busy-union and idle arithmetic on a synthetic Chrome trace, and the
device metrics read from it."""

import bench_paths  # noqa: F401  (sys.path for the harness)

import json

import pytest

from harness import spec, trace, window


def chrome(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_union_and_gaps():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert trace.union(spans) == pytest.approx(4.0)
    assert trace.gaps(spans, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert trace.gaps(spans, -1.0, 2.5) == [(-1.0, 0.0)]
    assert trace.union([]) == 0.0


def test_events_on_the_host_clock(tmp_path):
    path = tmp_path / "t.json"
    # trace clock in microseconds; the marker is the first device event
    chrome(path, [
        kernel("marker_fill", 1_000_000.0, 2.0),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 5.0},
        kernel("void inf::msm_accum_kernel<G1>", 1_000_100.0, 300.0),
        kernel("Memcpy HtoD", 1_000_500.0, 100.0, cat="gpu_memcpy"),
        kernel("inf::fr_ntt_tile_kernel", 1_000_550.0, 100.0),
    ])
    events = trace.read_events(str(path), mark_host=50.0)
    assert len(events) == 4
    assert events[0].start == pytest.approx(50.0)
    accum = events[1]
    assert accum.start == pytest.approx(50.0 + 100e-6)
    assert accum.end == pytest.approx(50.0 + 400e-6)
    t = trace.Trace(events[1:], 50.0, 50.001)
    assert t.window_s == pytest.approx(0.001)
    # 300 us of accumulation, then 150 us of copy and tile overlapped
    assert t.busy_s == pytest.approx(450e-6)
    assert t.kernel_s(("msm_accum",)) == pytest.approx(300e-6)
    assert t.kernel_s(("fr_ntt_tile",)) == pytest.approx(100e-6)


def test_device_metrics_and_idle_labels():
    ev = trace.Event
    events = [ev("kernel", "inf::fr_rows_kernel", 0.10, 0.11),
              ev("kernel", "inf::msm_accum_kernel<a>", 0.20, 0.26),
              ev("kernel", "inf::msm_weighted_chunks<a>", 0.26, 0.30),
              ev("gpu_memcpy", "Memcpy DtoH", 0.30, 0.31)]
    t = trace.Trace(events, 0.0, 1.0)
    rec = window.ProofRecord(index=0, witness=0, seed=1, start=0.0,
                             proved=0.4, verified=0.9, end=0.95, ok=True,
                             stages={"h_dispatch": 0.1, "witness_limbs": 0.0,
                                     "msm_dispatch": 0.1, "msm_wait": 0.15})
    run = window.Run([rec], 0.0, 1.0, setup_s=1.0, trace=t)
    assert spec.reader("h_device_ms")(run) == pytest.approx(10.0)
    assert spec.reader("msm_device_ms")(run) == pytest.approx(100.0)
    assert spec.reader("device_idle_share")(run) == pytest.approx(88.0)
    assert spec.reader("prove_ms")(run) == pytest.approx(400.0)
    assert spec.reader("verify_ms")(run) == pytest.approx(500.0)
    assert spec.reader("h_dispatch_ms")(run) == pytest.approx(100.0)
    idle = trace.idle_by_host(t, [rec])
    # gaps 0-0.10, 0.11-0.20, 0.31-1.0 over the host's stages
    assert sum(idle.values()) == pytest.approx(0.88)
    assert idle["prove.h_dispatch"] == pytest.approx(0.10)
    assert idle["prove.msm_dispatch"] == pytest.approx(0.09)
    assert idle["prove.msm_wait"] == pytest.approx(0.04)
    assert idle["prove.assembly"] == pytest.approx(0.05)
    assert idle["verify"] == pytest.approx(0.5)
    assert idle["serialize"] == pytest.approx(0.05)
    assert idle["between"] == pytest.approx(0.05)
    out = trace.breakdown(t, [rec])
    assert out["device_ops"][0] == ["inf::msm_accum_kernel<a>",
                                    pytest.approx(0.06)]
    assert out["idle_gaps"][0][0] == "verify"


def test_no_trace_reads_nothing():
    run = window.Run([], 0.0, 1.0, setup_s=1.0)
    for name in ("h_device_ms", "msm_device_ms", "msm_roofline",
                 "device_idle_share", "prove_ms", "verify_ms",
                 "h_dispatch_ms"):
        assert spec.reader(name)(run) is None
