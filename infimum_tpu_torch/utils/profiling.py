# Copied from infimum_tpu/utils/profiling.py; the stage clock ends with
# torch.cuda.synchronize and trace() wraps torch.profiler.
"""Timing / profiling harness for the proving pipeline.

  - Stopwatch: nestable named stages with wall time + optional device sync,
    rendered as an ordered report or a JSON dict (the e2e records prove()'s
    stages from it).
  - trace(): context manager wrapping torch.profiler.profile when
    INFIMUM_PROFILE_DIR is set, writing a Chrome trace there, so any run
    can emit a Perfetto-readable trace without code changes.

Device timing convention: CUDA launches are async; a stage that launches
device work only measures enqueue time unless it ends with a sync. Pass
`sync=` a CUDA device or tensor (torch.cuda.synchronize on its device) or
rely on host readbacks.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Stage:
    name: str
    seconds: float
    depth: int


def _cuda_device(sync):
    """The CUDA device `sync` names (a device, its name or a tensor on
    it), else None."""
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    return dev if dev.type == "cuda" else None


@dataclass
class Stopwatch:
    stages: list[Stage] = field(default_factory=list)
    _depth: int = 0

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a named stage; `sync` is an optional CUDA device or tensor
        whose device is synchronised before stopping the clock (forces
        queued device work to finish); a CPU one needs no wait."""
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield
        finally:
            if sync is not None:
                dev = _cuda_device(sync)
                if dev is not None:
                    torch.cuda.synchronize(dev)
            self._depth -= 1
            self.stages.append(
                Stage(name, time.perf_counter() - t0, self._depth))

    def report(self) -> str:
        lines = []
        for s in reversed(self.stages):
            lines.append(f"{'  ' * s.depth}{s.name}: {s.seconds:.2f}s")
        return "\n".join(lines)

    def as_dict(self, prefix: str = "") -> dict:
        return {f"{prefix}{s.name}": round(s.seconds, 3)
                for s in self.stages if s.depth == 0}

    def json(self) -> str:
        return json.dumps(self.as_dict())


@contextlib.contextmanager
def trace(label: str = "infimum"):
    """torch.profiler trace gated on INFIMUM_PROFILE_DIR (no-op otherwise):
    host and, when a card is present, CUDA activity, written as the Chrome
    trace `<INFIMUM_PROFILE_DIR>/<label>.json`."""
    out = os.environ.get("INFIMUM_PROFILE_DIR")
    if not out:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"{label}.json"))
