"""The port's stage trace (infimum_tpu_torch.utils.profiling and prove()'s
LAST_PROVE_TRACE) against the reference's.

Nested stages timed by one scripted clock give the same `as_dict`,
`report` and `json` in both packages' Stopwatch; a CPU sync is a no-op; a
prove() on the CPU records exactly the reference's four stage names;
INFIMUM_TRACE prints the report; trace() writes a Chrome trace only under
INFIMUM_PROFILE_DIR."""

import json
import random
import time

import pytest
import torch

from infimum_tpu.utils import profiling as ref
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.utils import profiling as port

from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes

STAGES = ["h_dispatch", "witness_limbs", "msm_dispatch", "msm_wait"]
# clock readings: each stage reads the clock on entry and on exit
TICKS = [0.0, 0.25, 1.0, 1.5, 3.75, 4.0, 9.125, 10.0, 12.5, 20.0]


def _nested(sw):
    with sw.stage("prove"):
        with sw.stage("h"):
            with sw.stage("ntt"):
                pass
        with sw.stage("msm"):
            pass
    with sw.stage("verify"):
        pass
    return sw


@pytest.mark.parametrize("prefix", ["", "process_"])
def test_stopwatch_matches_reference(prefix, monkeypatch):
    out = []
    for mod in (port, ref):
        clock = iter(TICKS)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        sw = _nested(mod.Stopwatch())
        out.append((sw.as_dict(prefix), sw.report(), sw.json(),
                    [(s.name, s.seconds, s.depth) for s in sw.stages]))
    assert out[0] == out[1]
    assert list(out[0][0]) == [prefix + "prove", prefix + "verify"]


@pytest.mark.parametrize("sync", ["cpu", torch.device("cpu"),
                                  torch.zeros(2)])
def test_cpu_sync_is_a_no_op(sync):
    sw = port.Stopwatch()
    with sw.stage("s", sync=sync):
        pass
    assert [s.name for s in sw.stages] == ["s"]


def test_prove_records_the_reference_stages(monkeypatch, capsys):
    cs, w = _toy_witness()
    pk = g16.setup(cs, random.Random(42), device="cpu")
    monkeypatch.setenv("INFIMUM_TRACE", "1")
    g16.prove(pk, cs, w, random.Random(43), device="cpu")
    trace = g16.LAST_PROVE_TRACE
    assert list(trace) == STAGES
    assert all(isinstance(v, float) and v >= 0 for v in trace.values())
    err = capsys.readouterr().err.splitlines()
    assert [line.split(":")[0] for line in err] == STAGES[::-1]


def test_trace_writes_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("INFIMUM_PROFILE_DIR", str(tmp_path))
    with port.trace("step"):
        torch.ones(4).sum()
    events = json.loads((tmp_path / "step.json").read_text())["traceEvents"]
    assert events


def test_trace_off_without_profile_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("INFIMUM_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with port.trace("step"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
