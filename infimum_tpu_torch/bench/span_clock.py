"""The span log on a card: its clock against the device trace's, and its
cost.

    python3 infimum_tpu_torch/bench/span_clock.py [--n N] [--out DIR]

A chain circuit out = x prod_i (x + k_i) of N full-width multiplications
(N = 2^17 - 4 by default: domain 2^18, the process circuit's) is set up
on the card and proved five times (each one's `msm_wait.card` plus
`msm_wait.combine` beside `LAST_PROVE_TRACE`'s rounded `msm_wait`, and
`h_dispatch.words` beside `h_dispatch`); one more prove and a verify
give the spans of a proof; a last prove runs under
`utils.profiling.trace`, whose Chrome trace (written to DIR, default
`.logs/span_clock`, gitignored) holds the device's kernels and the
program's spans on one clock, tied by a marker kernel at each end and
the markers then taken out (its kernels are counted beside those of a
plain torch.profiler trace of one more prove). Then, read from that
file: every MSM kernel must start after `prove.msm_dispatch` starts, and
the last must end before `prove.msm_wait.card` ends; the largest
violation of either, in microseconds, is the clock tie's error (the
marker kernel's launch latency is the expected size); beside it, each
MSM kernel's start less its launch call's, which reads the trace's own
device clock against its host clock. Also printed: the cost of a span,
a stage and a `record` (ns, a loop of 10^5 on this host), the spans of
one prove and verify, the verify phases' milliseconds over 20 verifies,
and the card's name and power limit. One JSON line last."""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import statistics
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from infimum_tpu_torch.ff.bn254 import FR_MOD  # noqa: E402
from infimum_tpu_torch.groth16 import groth16 as g16  # noqa: E402
from infimum_tpu_torch.groth16.r1cs import LC, ConstraintSystem  # noqa: E402
from infimum_tpu_torch.utils import profiling  # noqa: E402

MSM_KERNELS = ("msm_recode", "msm_scatter", "msm_compact", "msm_accum",
               "msm_weighted")


def chain_circuit(n: int, seed: int = 7):
    """(cs, witness, publics) of out = x prod_i (x + k_i), full-width k_i."""
    rng = random.Random(seed)
    ks = [rng.randrange(FR_MOD) for _ in range(n)]
    cs = ConstraintSystem()
    out = cs.alloc_public()
    x = cs.alloc()
    acc = LC.var(x)
    for k in ks:
        acc = cs.mul(acc, LC.var(x) + LC.const(k))
    cs.enforce_zero(acc - LC.var(out))
    xv = rng.randrange(FR_MOD)
    v = xv
    for k in ks:
        v = v * (xv + k) % FR_MOD
    return cs, cs.compute_witness({out: v, x: xv}), [v]


def per_op_ns(fn, n: int = 100_000) -> float:
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e9


def span_costs() -> dict:
    def one_span():
        with profiling.span("cost.span"):
            pass

    sw = profiling.Stopwatch("cost")

    def one_stage():
        with sw.stage("stage"):
            pass

    def one_record():
        profiling.record("cost.record", 0.0, 0.0)

    costs = {"span_ns": per_op_ns(one_span),
             "stage_ns": per_op_ns(one_stage),
             "record_ns": per_op_ns(one_record),
             "perf_counter_ns": per_op_ns(time.perf_counter)}
    sw.stages.clear()
    return costs


def clock_check(path: str) -> dict:
    """The MSM kernels of the traced prove against its spans, in us."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"
               and any(k in e.get("name", "") for k in MSM_KERNELS)]
    dispatch = spans["prove.msm_dispatch"]
    card = spans["prove.msm_wait.card"]
    first = min(k["ts"] for k in kernels)
    last = max(k["ts"] + k["dur"] for k in kernels)
    # the kernels' launch calls, on the trace's host clock (the spans are
    # on its device clock)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    calls = [launch[k["args"]["correlation"]] for k in kernels
             if k.get("args", {}).get("correlation") in launch]
    # a kernel's start less its launch call's: the trace's device clock
    # against its host clock (a launch takes some us)
    lag = [k["ts"] - launch[k["args"]["correlation"]] for k in kernels
           if k.get("args", {}).get("correlation") in launch]
    early = dispatch["ts"] - first          # > 0: a kernel before dispatch
    late = last - (card["ts"] + card["dur"])  # > 0: one after the wait
    return {
        "msm_kernels": len(kernels),
        "first_kernel_after_dispatch_start_us": first - dispatch["ts"],
        "last_kernel_before_card_end_us": card["ts"] + card["dur"] - last,
        "largest_violation_us": max(0.0, early, late),
        "first_launch_after_dispatch_start_us":
            min(calls) - dispatch["ts"] if calls else None,
        "kernel_after_launch_us": [min(lag), max(lag)] if lag else None,
        "spans_in_trace": len(spans),
        "program_spans_and_kernels_on_one_file": bool(spans and kernels),
    }


def kernel_count(path: str) -> int:
    """The device kernels of a Chrome trace (what `chip_smoke.py`'s
    `traced_prove` counts)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel")


def plain_trace(path: str, fn) -> None:
    """fn() under torch.profiler alone, no marker, exported to `path`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def verify_phases(pk, proof, publics, runs: int = 20) -> dict:
    out: dict = {}
    for _ in range(runs):
        t0 = time.perf_counter()
        assert g16.verify(pk.vk, proof, publics)
        for s in profiling.spans(t0, time.perf_counter()):
            out.setdefault(s.name, []).append((s.end - s.start) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=(1 << 17) - 4)
    p.add_argument("--out", default=str(REPO / ".logs" / "span_clock"))
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    t = time.perf_counter()
    cs, witness, publics = chain_circuit(args.n)
    pk = g16.setup(cs, random.Random(11), device="cuda")
    print(f"[span_clock] circuit of {len(cs.constraints)} constraints and "
          f"its key in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    steady, split = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = g16.prove(pk, cs, witness, random.Random(i), device="cuda")
        steady.append((time.perf_counter() - t) * 1e3)
        ms = {s.name: (s.end - s.start) * 1e3
              for s in profiling.spans(t, time.perf_counter())}
        split.append({"card_plus_combine": ms["prove.msm_wait.card"]
                      + ms["prove.msm_wait.combine"],
                      "msm_wait_stage": g16.LAST_PROVE_TRACE["msm_wait"] * 1e3,
                      "words": ms["prove.h_dispatch.words"],
                      "h_dispatch_stage":
                          g16.LAST_PROVE_TRACE["h_dispatch"] * 1e3})
    t0 = time.perf_counter()
    g16.prove(pk, cs, witness, random.Random(3), device="cuda")
    g16.verify(pk.vk, proof, publics)
    one = profiling.spans(t0, time.perf_counter())
    os.environ["INFIMUM_PROFILE_DIR"] = args.out
    with profiling.trace("steady_prove"):
        proof = g16.prove(pk, cs, witness, random.Random(4), device="cuda")
        torch.cuda.synchronize()
    plain = os.path.join(args.out, "plain_prove.json")
    plain_trace(plain, lambda: g16.prove(pk, cs, witness, random.Random(5),
                                         device="cuda"))
    traced = os.path.join(args.out, "steady_prove.json")
    result = {
        "card": card.strip(),
        "steady_prove_ms": steady,
        "stage_split_ms": split,
        "spans_per_prove_and_verify": len(one),
        "span_names": sorted({s.name for s in one}),
        "clock": clock_check(traced),
        # trace() takes its markers out: the same kernels as a plain trace
        "kernels_traced_plain": [kernel_count(traced), kernel_count(plain)],
        "verify_phase_ms": verify_phases(pk, proof, publics),
        "costs": span_costs(),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
