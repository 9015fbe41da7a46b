"""The benchmark's description, found by name: `BENCHMARK.json` at the root
of the checkout, and the files it names under `benchmark/`.

- a configuration is `benchmark/configs/<config>.json` (its `file`);
- a traffic mix is `benchmark/traffic/<traffic>.json`;
- a metric, end-to-end or per-layer, is `benchmark/metrics/<name>.py`,
  whose `read(run)` returns its value or None where it finds nothing.

A later cell, mix or metric is added as files and entries; nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(Exception):
    """A name the benchmark's files do not resolve."""


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _one(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise SpecError(f"{what} {name!r}: {len(found)} entries in "
                        f"BENCHMARK.json")
    return found[0]


def cell(spec: dict, name: str) -> dict:
    return _one(spec["workloads"], name, "workload")


def config(spec: dict, name: str) -> dict:
    """The configuration's file as it is run."""
    entry = _one(spec["configs"], name, "configuration")
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    path = BENCH_DIR / "traffic" / f"{name}.json"
    if not path.exists():
        raise SpecError(f"traffic {name!r}: no {path.name} under traffic/")
    with open(path) as f:
        return json.load(f)


def metrics(spec: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones untraced,
    its per-layer ones traced; an entry with `workloads` applies to the
    cells it lists, one without to every cell."""
    entries = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def module(name: str):
    """benchmark/metrics/<name>.py, loaded."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        raise SpecError(f"metric {name!r}: no {path.name} under metrics/")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """`read(run)` of benchmark/metrics/<name>.py."""
    return module(name).read
