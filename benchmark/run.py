"""The benchmark of infimum_tpu_torch on an NVIDIA GPU: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of BENCHMARK.json names a configuration (benchmark/configs/), a
traffic mix (benchmark/traffic/) and its metrics (benchmark/metrics/).
The run sets up the cell's deployment and a closed poll made from the
seed, warms up, measures a coordinator's backlog for `--seconds`, checks
every proof of the window against the plain reference, and prints one JSON
line last on standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones
from a profiled window), `device`, with `--trace 1` `breakdown`, and
`compared`, each number compared beside its limit, which are also the last
lines on standard error.

It exits with another code than 0, and prints no result, without the CUDA
devices the cell asks for, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

SETUP_START = time.perf_counter()
BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
# one thread for the host's numerical libraries: the prover's host path is
# one Python thread, and the load stays one thread on a shared host
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
os.environ.update(dict.fromkeys(THREAD_ENV, "1"))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def stage(name: str, t0: float) -> float:
    """Print a set-up stage's seconds on standard error; the time now."""
    now = time.perf_counter()
    print(f"[setup] {name} {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


def main(argv) -> int:
    args = parse(argv)
    from harness import spec

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch

    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    readers = {m["name"]: (m, spec.reader(m["name"]))
               for m in spec.metrics(bench, args.workload, bool(args.trace))}

    from harness import cell as cells
    from harness.runner import ForbiddenModules, measure

    t = time.perf_counter()
    dep = cells.deploy(spec.config(bench, cell["config"]),
                       spec.traffic(cell["traffic"]))
    t = stage("deploy", t)
    inputs = cells.make_inputs(dep, args.seed)
    t = stage("poll and witnesses", t)
    cells.warm_up(dep, inputs)
    torch.cuda.synchronize()
    stage("warm-up proofs", t)
    try:
        result = measure(dep, inputs, readers, args.seconds, args.seed,
                         SETUP_START, traced=bool(args.trace))
    except ForbiddenModules as e:
        print(e, file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
