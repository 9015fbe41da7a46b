# Copied from infimum_tpu/utils/profiling.py; the stages are spans of one
# in-process log, and trace() wraps torch.profiler and writes the log into
# its Chrome trace.
"""Timing and profiling of the proving pipeline.

  - The span log: every timed interval of the program, a `Span`, in one
    bounded in-process ring (`RING` spans, the oldest dropped first), on
    the `time.perf_counter` clock, unrounded. A span has a name, a start,
    an end, the span it opened under (its parent), the proof id of the
    enclosing `proof_scope` and, where the code gives them, integer
    counters of the work it carried (`span(name, **counts)`, or `count`
    inside the block: `prove.h_dispatch` its domain and row terms,
    `prove.msm_dispatch` each query's rows). `span(name)` times a block;
    `record(name, start, end)` logs an interval timed elsewhere (the
    native verifier's phases, whose CLOCK_MONOTONIC is perf_counter's
    clock on Linux);
    `spans(start, end)` returns the spans inside an interval, or None
    where the ring has dropped one that may have lain there. Always on:
    a span costs two clock reads and an append. Under INFIMUM_TRACE each
    proof's spans are printed to standard error, one line each (a
    `proof_scope`'s all together as it closes: the wait for its witness,
    prove, verify, serialization), its counters after its time.
  - Stopwatch: nestable named stages over the log, each stage a span
    under the caller's; `as_dict` gives the top-level stages' seconds,
    rounded to 1 ms (prove()'s LAST_PROVE_TRACE).
  - trace(): torch.profiler over a block when INFIMUM_PROFILE_DIR is set,
    written as a Chrome trace there with the log's spans of the block on
    the device events' clock (tied by a marker kernel at each end of the
    block, the markers then taken out of the file), so one Perfetto file
    shows each idle gap of the card under the host span it fell in.

Device timing convention: CUDA launches are async; a span that launches
device work measures its enqueue, and the host waits for the card only
where it reads back.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field

RING = 1 << 16   # spans kept: about 20 a proof, a few proofs a second


@dataclass(slots=True)
class Span:
    """One timed interval; as a context manager it times its block and
    logs itself when the block exits (by an exception too)."""
    name: str
    start: float          # time.perf_counter seconds
    end: float            # 0.0 while the span is open
    id: int
    parent: int | None    # the id of the span it opened under
    depth: int            # 0 at the top
    proof: object         # the enclosing proof_scope's id, or None
    counts: dict | None = None   # {counter: int}; None where it has none
    _token: object = field(default=None, repr=False, compare=False)

    def __enter__(self) -> "Span":
        self._token = _open.set(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        _open.reset(self._token)
        self._token = None
        _append(self)

    def count(self, **counts: int) -> None:
        """Add integer counters of the work the span carries."""
        self.counts = {**(self.counts or {}),
                       **{k: int(v) for k, v in counts.items()}}


_LOG: deque = deque(maxlen=RING)
_lost_end = None   # the latest end of a span the ring dropped
_ids = itertools.count()
_open: contextvars.ContextVar = contextvars.ContextVar("infimum_span",
                                                       default=None)
_proof: contextvars.ContextVar = contextvars.ContextVar("infimum_proof",
                                                        default=None)


def _append(sp: Span) -> None:
    # one thread records (the coordinator's); the GIL keeps each deque
    # operation whole
    global _lost_end
    if len(_LOG) == RING:
        dropped = _LOG[0].end
        _lost_end = dropped if _lost_end is None else max(_lost_end, dropped)
    _LOG.append(sp)


def _new(name: str, start: float) -> Span:
    parent = _open.get()
    return Span(name, start, 0.0, next(_ids),
                None if parent is None else parent.id,
                0 if parent is None else parent.depth + 1, _proof.get())


def span(name: str, **counts: int) -> Span:
    """`with span(name, **counts) as sp:` times the block as a span under
    the open one, with the given counters; `sp.end` is set when the block
    exits."""
    sp = _new(name, 0.0)
    if counts:
        sp.count(**counts)
    return sp


def count(**counts: int) -> None:
    """Add integer counters to the innermost open span, if one is open."""
    sp = _open.get()
    if sp is not None:
        sp.count(**counts)


def record(name: str, start: float, end: float) -> Span:
    """Log an interval timed elsewhere, on the perf_counter clock, as a
    span under the open one."""
    sp = _new(name, start)
    sp.end = end
    _append(sp)
    return sp


@contextlib.contextmanager
def proof_scope(proof_id):
    """Every span opened or recorded in the block carries `proof_id`; under
    INFIMUM_TRACE the block's spans are printed as it closes."""
    token = _proof.set(proof_id)
    start = time.perf_counter()
    try:
        yield
    finally:
        _proof.reset(token)
        if os.environ.get("INFIMUM_TRACE"):
            mine = [s for s in spans(start) or [] if s.proof == proof_id]
            print(f"proof {proof_id!r}:\n"
                  + format_spans(sorted(mine,
                                        key=lambda s: (s.start, s.depth))),
                  file=sys.stderr, flush=True)


def print_trace(tree: list[Span]) -> None:
    """Under INFIMUM_TRACE, print `tree` (`format_spans`) to standard error,
    unless a `proof_scope` is open: it prints all its spans as it closes."""
    if os.environ.get("INFIMUM_TRACE") and _proof.get() is None:
        print(format_spans(tree), file=sys.stderr, flush=True)


def spans(start: float = float("-inf"),
          end: float = float("inf")) -> list[Span] | None:
    """The spans that lie inside [start, end], in the order they ended;
    None when the ring has dropped a span that ended at or after `start`
    (one that may have lain inside)."""
    if _lost_end is not None and _lost_end >= start:
        return None
    return [s for s in list(_LOG) if s.start >= start and s.end <= end]


def subtree(root: Span) -> list[Span]:
    """`root` and the spans under it, each after its parent, in the order
    they started."""
    ids, out = {root.id}, [root]
    for s in sorted(spans(root.start, root.end) or [],
                    key=lambda s: (s.start, s.depth)):
        if s.parent in ids:
            ids.add(s.id)
            out.append(s)
    return out


def format_spans(tree: list[Span]) -> str:
    """One line a span: indented by its depth under the shallowest, its
    name and milliseconds, then its counters as `name=value`."""
    base = min((s.depth for s in tree), default=0)
    return "\n".join(
        f"{'  ' * (s.depth - base)}{s.name}: {(s.end - s.start) * 1e3:.3f} ms"
        + "".join(f" {k}={v}" for k, v in (s.counts or {}).items())
        for s in tree)


@dataclass
class Stage:
    name: str
    seconds: float
    depth: int


@dataclass
class Stopwatch:
    """Nestable named stages, each also a span of the log, named
    `<name>.<stage>` (`<name>.<outer>.<inner>` nested; without a name
    `<stage>`)."""
    name: str = ""
    stages: list[Stage] = field(default_factory=list)
    _path: list[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, **counts: int):
        depth = len(self._path)
        self._path.append(name)
        full = ".".join(([self.name] if self.name else []) + self._path)
        try:
            with span(full, **counts) as sp:
                yield sp
        finally:
            self._path.pop()
            self.stages.append(Stage(name, sp.end - sp.start, depth))

    def as_dict(self) -> dict:
        """The top-level stages' seconds, rounded to 1 ms, in the order
        they ended."""
        return {s.name: round(s.seconds, 3)
                for s in self.stages if s.depth == 0}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "infimum.clock_mark"
SPAN_TID = 1 << 30   # the spans' track in the trace's process


def _mark(cuda: bool, warm: bool = False) -> float:
    """The host time of a clock tie: on a card one small kernel, else a
    `MARK` range. `warm` launches one first, which pays the profiler's
    set-up on its first op (some hundred us between the clock read and
    the kernel)."""
    import torch
    from torch.profiler import record_function

    for _ in range(2 if warm else 1):
        if cuda:
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
        else:
            t = time.perf_counter()
            with record_function(MARK):
                pass
    return t


def _merge_spans(path: str, marks: tuple[float, float], cuda: bool,
                 logged) -> None:
    """Write `logged` into the Chrome trace at `path` on its events' clock:
    the host times `marks` are the block's two ties, the trace's second
    and last device events (`MARK` ranges on the CPU), and a host time
    between maps onto the line through them, so a drift of the trace's
    device clock against the host's is taken out. The three marker events
    are then taken out of the trace."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    if cuda:
        ties = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in DEVICE_CATS]
    else:
        ties = [e for e in events
                if e.get("ph") == "X" and e.get("name") == MARK]
    if len(ties) < 3:
        return
    ties.sort(key=lambda e: e["ts"])
    # the three marker events go: the trace keeps the block's own work
    dropped = {id(e) for e in ties[:2] + ties[-1:]}
    events = doc["traceEvents"] = [e for e in events
                                   if id(e) not in dropped]
    (h0, h1), d0 = marks, float(ties[1]["ts"])
    rate = ((float(ties[-1]["ts"]) - d0) / ((h1 - h0) * 1e6) if h1 > h0
            else 1.0)

    def at(h: float) -> float:
        return d0 + (h - h0) * 1e6 * rate

    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TID, "args": {"name": "program spans"}})
    for s in sorted(logged or [], key=lambda s: (s.start, s.depth)):
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": SPAN_TID, "ts": at(s.start),
            "dur": at(s.end) - at(s.start),
            "args": {"proof": repr(s.proof), "id": s.id,
                     "parent": s.parent, **(s.counts or {})}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(label: str = "infimum"):
    """torch.profiler trace gated on INFIMUM_PROFILE_DIR (no-op otherwise):
    host and, when a card is present, CUDA activity, with the span log's
    spans of the block, written as the Chrome trace
    `<INFIMUM_PROFILE_DIR>/<label>.json`."""
    out = os.environ.get("INFIMUM_PROFILE_DIR")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        start = _mark(cuda, warm=True)
        yield
        end = _mark(cuda)
    path = os.path.join(out, f"{label}.json")
    prof.export_chrome_trace(path)
    _merge_spans(path, (start, end), cuda, spans(start, end))
