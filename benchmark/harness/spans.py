"""The program's own span log (`infimum_tpu_torch/utils/profiling.py`), as
the per-layer metrics of source `program_span` read it.

A span lies in an interval when it starts and ends inside it. A window's
metric sums the durations of one span name's spans inside the window and
divides by the window's finished proofs, as `prove_ms` does, so the
warm-up's spans, prewarm's and those of the check after the window fall
outside; a set-up metric sums its spans that end before the window opens.
Each returns None where the log has none of that name, where the ring has
dropped a span that may have lain in the interval, or where the program
keeps no span log.
"""

from __future__ import annotations


def _inside(start: float, end: float):
    from infimum_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read(start, end)


def _seconds(found, name: str) -> float | None:
    mine = [s.end - s.start for s in found or () if s.name == name]
    return sum(mine) if mine else None


def per_proof_ms(run, name: str) -> float | None:
    """Milliseconds of the spans named `name` in the window, a finished
    proof."""
    done = run.done
    if not done:
        return None
    total = _seconds(_inside(run.start, run.end), name)
    return None if total is None else total / len(done) * 1e3


def setup_s(run, name: str) -> float | None:
    """Seconds of the spans named `name` that end before the window."""
    return _seconds(_inside(float("-inf"), run.start), name)
