"""One run of a cell after set-up: the window, the metrics, the check for
JAX, and the comparison that decides `correct`; the result line."""

from __future__ import annotations

import functools
import sys
import time

from infimum_tpu_torch.groth16.groth16 import Proof

from . import check, nojax, trace as tracing, window, yardstick
from .cell import (Deployment, Inputs, coordinator_step, program_prove,
                   program_verify)
from .reference import Groth16Reference, domain_size


class ForbiddenModules(Exception):
    """JAX or the JAX package was loaded in the process."""


def measure(dep: Deployment, inputs: Inputs, readers: dict, seconds: float,
            seed: int, setup_start: float, traced: bool = False,
            prove=program_prove) -> dict:
    """The result line of a run whose set-up began at `setup_start` (host
    clock): `readers` maps each metric's name to (its BENCHMARK.json entry,
    its read)."""
    setup_s = time.perf_counter() - setup_start
    step = coordinator_step(dep, inputs, prove)

    def loop():
        return window.closed_loop(step, len(inputs.witnesses), seconds, seed)

    print(f"[setup] {setup_s:.3f} s in all", file=sys.stderr, flush=True)
    cuda = dep.device == "cuda"
    trace = None
    if traced:
        records, start, end, trace = tracing.traced(loop)
    else:
        records, start, end = loop()
    device = {"platform": "cpu", "kind": "cpu", "count": 0,
              "memory_peak_bytes": 0}
    if cuda:
        import torch

        torch.cuda.synchronize()
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": 1,
                  "memory_peak_bytes": torch.cuda.max_memory_allocated(0)}
    proof_msms = None
    if traced:
        supports = yardstick.query_supports(dep.cs)
        h_count = domain_size(dep.cs) - 1
        proof_msms = functools.lru_cache(maxsize=None)(
            lambda k: yardstick.proof_msms(supports, inputs.witnesses[k],
                                           h_count))
    run = window.Run(records, start, end, setup_s, trace, proof_msms)
    metrics = {}
    for name, (entry, read) in readers.items():
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)

    t = time.perf_counter()
    ref = Groth16Reference(dep.cs, dep.config["key_seed"])
    numbers = check.compare(
        ref, dep.cs, dep.config["circuits"][dep.mix["circuit"]],
        inputs.witnesses, inputs.publics, records,
        functools.partial(program_verify, dep), Proof, seed)
    print(f"[check] {len(records)} proofs against the reference in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    result = {"correct": check.verdict(numbers, len(records)),
              "attempted": len(records),
              "failed": numbers["failed_proofs"],
              "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = tracing.breakdown(trace, records)
    errors = sorted({r.error for r in records if r.error})
    if errors:
        print(f"proof errors: {errors[:5]}", file=sys.stderr)
    result["compared"] = check.compared_line(numbers)
    found = nojax.loaded()
    if found:
        raise ForbiddenModules(f"loaded in this process: {', '.join(found)}")
    return result
