"""The comparison's readings at a cell's own size, in one process: the
program on the given seeds, and the control in its place on others.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --program-seeds <n,...> --control-seeds <n,...>

One set-up serves every seed; each seed makes its own poll and witnesses,
then a window of `--seconds` runs the coordinator's loop and every proof
is compared with the reference, as a run of the benchmark does. The
control (`harness.check.control_prove`) is the reference with the witness
MSMs' scalars cut to their low bits, put in the program's place. One JSON
line a seed on standard output, then a summary: the largest readings of
the program and the smallest of the control, each number's limit beside
them. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
# the host's numerical libraries on one thread, as run.py runs them
os.environ.update(dict.fromkeys(
    ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"), "1"))


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from harness import cell as cells, check, spec
    from harness.reference import Groth16Reference
    from harness.runner import measure
    from infimum_tpu_torch.groth16.groth16 import Proof

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    dep = cells.deploy(spec.config(bench, cell["config"]),
                       spec.traffic(cell["traffic"]))
    ref = Groth16Reference(dep.cs, dep.config["key_seed"])
    control = check.control_prove(ref, Proof)
    readings = {"program": [], "control": []}
    for kind, prove, run_seeds in (
            ("program", cells.program_prove, args.program_seeds),
            ("control", control, args.control_seeds)):
        for seed in run_seeds:
            inputs = cells.make_inputs(dep, seed)
            cells.warm_up(dep, inputs)
            result = measure(dep, inputs, {}, args.seconds, seed,
                             time.perf_counter(), prove=prove)
            numbers = {k: v["value"] for k, v in result["compared"].items()}
            readings[kind].append(numbers)
            print(json.dumps({"kind": kind, "seed": seed,
                              "correct": result["correct"],
                              "attempted": result["attempted"],
                              "compared": numbers}), flush=True)
    summary = {"workload": args.workload, "limits": check.LIMITS}
    for kind, pick in (("program", max), ("control", min)):
        if readings[kind]:
            summary[kind] = {k: pick(r[k] for r in readings[kind])
                             for k in check.LIMITS}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
