"""The measured window: a coordinator's closed loop over its ready batches,
and the arithmetic of its end-to-end numbers.

One prover works through the cell's witnesses in turn, as
`PollProver._prove_stream` does: prove, self-verify, serialize, then the
next batch. A proof starts only while the window is open; the window ends
when the last proof started in it is serialized, so its rate is taken over
all the work and all the time it held.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class ProofRecord:
    """One batch's pass through the loop, on the host clock (seconds of
    time.perf_counter)."""
    index: int                 # its place in the window
    witness: int               # which of the cell's witnesses
    seed: int                  # the seed of the rng handed to prove
    start: float               # the call to prove
    proved: float = 0.0        # prove returned
    verified: float = 0.0      # verify returned
    end: float = 0.0           # the proof serialized
    ok: bool = False           # proved, verified and serialized
    stages: dict = field(default_factory=dict)   # the program's stage spans
    proof: object = None
    error: str | None = None

    @property
    def latency(self) -> float:
        return self.end - self.start


def proof_seed(seed: int, index: int) -> int:
    """The seed of the rng that gives the index-th proof its r and s."""
    return seed * 1_000_003 + index


def closed_loop(step, n_witnesses: int, seconds: float, seed: int,
                clock=time.perf_counter) -> tuple[list[ProofRecord], float,
                                                   float]:
    """(records, start, end) of a window of `seconds`: `step(record)` fills
    each record in turn, cycling over the witnesses."""
    records: list[ProofRecord] = []
    t0 = clock()
    deadline = t0 + seconds
    while clock() < deadline:
        i = len(records)
        rec = ProofRecord(index=i, witness=i % n_witnesses,
                          seed=proof_seed(seed, i), start=clock())
        step(rec)
        if not rec.end:
            rec.end = clock()
        records.append(rec)
    return records, t0, max([clock()] + [r.end for r in records])


def rate(records: list[ProofRecord], window_s: float) -> float:
    """Proofs proved and self-verified per second of the window."""
    return sum(r.ok for r in records) / window_s


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-quantile (0 < q <= 1) of all values."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


@dataclass
class Run:
    """What a run hands its metric readers."""
    records: list[ProofRecord]
    start: float               # the window, host clock seconds
    end: float
    setup_s: float
    trace: object = None       # trace.Trace of a traced run
    proof_msms: object = None  # witness index -> yardstick.proof_msms

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def done(self) -> list[ProofRecord]:
        """The proofs proved, verified and serialized."""
        return [r for r in self.records if r.ok]
