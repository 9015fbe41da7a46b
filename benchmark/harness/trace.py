"""The device trace of a traced run: `torch.profiler` over the window
(device activity only, so that the host's spans keep their pace), read
back from its Chrome trace, and the arithmetic on it.

- busy time: the union of the intervals in which a kernel, a copy or a
  set ran (the arithmetic of `chip_smoke.py` `traced_prove`, copied);
- idle gaps: the rest of the window, split by what the host was doing,
  from the benchmark's own spans of each proof;
- kernel time by group: the sum of the kernels' durations whose names
  hold a group's string.

The host clock and the trace's clock are tied by a marker: one small
kernel launched at a known host time right after the profiler starts, the
first device event of the trace.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    cat: str
    name: str
    start: float   # host clock seconds (time.perf_counter)
    end: float


@dataclass
class Trace:
    events: list[Event]      # device events inside the window
    start: float             # the window, host clock seconds
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return union([(e.start, e.end) for e in self.events])

    def kernel_s(self, groups) -> float:
        """Seconds of the kernels whose names hold one of `groups`."""
        return sum(e.end - e.start for e in self.events
                   if e.cat == "kernel" and any(g in e.name for g in groups))


def union(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy


def gaps(spans, start: float, end: float) -> list[tuple[float, float]]:
    """The parts of [start, end] that no interval covers."""
    out, reach = [], start
    for a, b in sorted(spans):
        if a > reach:
            out.append((reach, min(a, end)))
        reach = max(reach, b)
        if reach >= end:
            break
    if reach < end:
        out.append((reach, end))
    return [(a, b) for a, b in out if b > a]


def read_events(path: str, mark_host: float) -> list[Event]:
    """The device events of a Chrome trace on the host clock: the first
    device event is the marker launched at `mark_host`."""
    with open(path) as f:
        raw = json.load(f)["traceEvents"]
    dev = [e for e in raw if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not dev:
        return []
    first = min(e["ts"] for e in dev)
    shift = mark_host - first * 1e-6
    return [Event(e["cat"], e.get("name", "?"), e["ts"] * 1e-6 + shift,
                  (e["ts"] + e["dur"]) * 1e-6 + shift) for e in dev]


def traced(run_window):
    """Run `run_window()` -> (records, start, end) under the profiler; the
    same with the window's Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as out:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            mark = time.perf_counter()
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            records, start, end = run_window()
            torch.cuda.synchronize()
        path = os.path.join(out, "window.json")
        prof.export_chrome_trace(path)
        events = read_events(path, mark)
    inside = [e for e in events if e.end > start and e.start < end]
    return records, start, end, Trace(inside, start, end)


def host_spans(records) -> list[tuple[str, float, float]]:
    """(label, start, end) of what the host did in each proof: the prover's
    stages as the program records them (in order, from the call), the rest
    of prove (assembly), verify and serialize."""
    spans = []
    for r in records:
        t = r.start
        for name, secs in r.stages.items():
            spans.append((f"prove.{name}", t, t + secs))
            t += secs
        if r.proved:
            spans.append(("prove.assembly", t, r.proved))
            if r.verified:
                spans.append(("verify", r.proved, r.verified))
                spans.append(("serialize", r.verified, r.end))
    return spans


def idle_by_host(trace: Trace, records) -> dict[str, float]:
    """Seconds of device idle in the window by what the host was doing:
    each idle gap split over the host spans it overlaps, the rest
    `between`."""
    spans = sorted(host_spans(records), key=lambda s: s[1])
    ends = [e for _, _, e in spans]
    out: dict[str, float] = {}
    for a, b in gaps([(e.start, e.end) for e in trace.events],
                     trace.start, trace.end):
        covered = 0.0
        for name, s, e in spans[bisect.bisect_right(ends, a):]:
            if s >= b:
                break
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
        if b - a > covered:
            out["between"] = out.get("between", 0.0) + (b - a - covered)
    return out


def breakdown(trace: Trace, records, top: int = 10) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time, and the idle time by what the host was doing."""
    ops: dict[str, float] = {}
    for e in trace.events:
        ops[e.name] = ops.get(e.name, 0.0) + (e.end - e.start)
    idle = idle_by_host(trace, records)
    return {
        "device_ops": [[n[:200], s] for n, s in sorted(
            ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }
