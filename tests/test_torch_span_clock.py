"""The span log's clock against the device trace's
(infimum_tpu_torch/bench/span_clock.py).

On the CPU: the script's chain circuit is satisfied, and its reading of a
Chrome trace finds the MSM kernels' margins to `prove.msm_dispatch`'s
start and `prove.msm_wait.card`'s end, and a violation of either. On a
card: the MSM kernels of one profiled steady prove start after
`prove.msm_dispatch` starts and end before `prove.msm_wait.card` ends,
within the clock tie's error (the marker kernel's launch latency), and
the file holds as many kernels as a plain profile of the same prove."""

import json
import random

import pytest
import torch

from infimum_tpu_torch.bench import span_clock
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TIE_US = 50.0   # the marker kernel's launch latency is a few us


def test_chain_circuit_is_satisfied():
    cs, witness, publics = span_clock.chain_circuit(40)
    assert cs.check(witness)
    assert len(cs.constraints) == 41 and publics == [witness[1]]


def _trace(tmp_path, kernels, dispatch, card):
    events = [{"ph": "X", "cat": "kernel", "name": f"fill_{n}", "ts": ts,
               "dur": 1.0} for n, ts in (("warm_up", 0.0), ("marker", 5.0))]
    events += [{"ph": "X", "cat": "kernel", "name": f"{n}_kernel", "ts": a,
                "dur": b - a, "args": {"correlation": i}}
               for i, (n, a, b) in enumerate(kernels)]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": a - 4.0, "dur": 3.0, "args": {"correlation": i}}
               for i, (n, a, b) in enumerate(kernels)]
    events += [{"ph": "X", "cat": "program_span", "name": n, "ts": a,
                "dur": b - a}
               for n, (a, b) in (("prove.msm_dispatch", dispatch),
                                 ("prove.msm_wait.card", card))]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.mark.parametrize("kernels, violation", [
    ([("msm_recode", 110.0, 120.0), ("msm_accum", 130.0, 400.0)], 0.0),
    ([("msm_recode", 97.0, 120.0), ("msm_weighted", 130.0, 400.0)], 3.0),
    ([("msm_scatter", 110.0, 120.0), ("msm_compact", 130.0, 507.5)], 7.5),
])
def test_clock_check_reads_the_margins(tmp_path, kernels, violation):
    got = span_clock.clock_check(_trace(tmp_path, kernels + [
        ("fr_ntt_tile", 50.0, 60.0)], (100.0, 150.0), (300.0, 500.0)))
    assert got["msm_kernels"] == 2
    assert got["largest_violation_us"] == pytest.approx(violation)
    assert got["first_kernel_after_dispatch_start_us"] == pytest.approx(
        kernels[0][1] - 100.0)
    assert got["last_kernel_before_card_end_us"] == pytest.approx(
        500.0 - kernels[1][2])
    assert got["first_launch_after_dispatch_start_us"] == pytest.approx(
        kernels[0][1] - 4.0 - 100.0)
    assert got["kernel_after_launch_us"] == [4.0, 4.0]


@pytest.mark.cuda
def test_msm_kernels_lie_between_dispatch_and_card_wait(tmp_path,
                                                        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiled prove runs the card's "
                    "kernels")
    cs, witness, _ = span_clock.chain_circuit(4000)
    pk = g16.setup(cs, random.Random(7), device="cuda")
    for i in range(2):
        g16.prove(pk, cs, witness, random.Random(i), device="cuda")
    monkeypatch.setenv("INFIMUM_PROFILE_DIR", str(tmp_path))
    with profiling.trace("prove"):
        g16.prove(pk, cs, witness, random.Random(2), device="cuda")
    got = span_clock.clock_check(str(tmp_path / "prove.json"))
    assert got["msm_kernels"] >= 10
    assert got["largest_violation_us"] <= TIE_US
    # the markers are out of the file: its kernels are the prove's alone
    plain = str(tmp_path / "plain.json")
    span_clock.plain_trace(plain, lambda: g16.prove(
        pk, cs, witness, random.Random(3), device="cuda"))
    assert span_clock.kernel_count(str(tmp_path / "prove.json")) == (
        span_clock.kernel_count(plain))
