# Copied from infimum_tpu/witness/parallel.py; the notes are the port's, and
# FALLBACK_BATCHES counts the batches that fell back.
"""Process-parallel witness generation across proof batches.

Batches are data-independent (each witness depends only on its own circuit
inputs), so forked worker processes compute them while the card runs the
proof of an earlier batch.

Implementation notes:
- Workers are forked, not spawned: the circuit object carries hint closures
  (groth16/r1cs.py hints are lambdas) that cannot cross a pickle boundary,
  but fork's copy-on-write address space shares them for free. The circuit
  is published through a module global before the fork so `initargs` never
  pickles it.
- A child runs only `circuit.assignment`: the native hint program through
  ctypes (native/), or the Python hints. It never calls torch, so it never
  touches the CUDA context the parent holds. `circuits/`, `witness/`,
  `groth16/r1cs.py` and `native/` import no torch.
- A child could still deadlock on a lock some thread of the parent held at
  the fork, so every result fetch carries a timeout
  (INFIMUM_WITNESS_TIMEOUT seconds per batch, default 600); on timeout the
  pool is terminated, the remaining batches are evaluated in this process,
  one after another, and FALLBACK_BATCHES counts them.
- Results stream in order (imap) so proving can start as soon as batch 0's
  witness lands and completed witnesses can be dropped after use.
- Batch inputs are {int: int} dicts and witness outputs int lists: plain
  data, cheap to pickle through the result pipe.
- Without fork (or with `processes=1`, or a single batch) the batches are
  evaluated in this process, one after another.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys

_FORK_CIRCUIT = None
_FORK_BATCHES = None
FALLBACK_BATCHES = 0   # batches evaluated in-process after a worker timeout


def _eval_batch(i: int) -> list[int]:
    return _FORK_CIRCUIT.assignment(_FORK_BATCHES[i])


def _batch_timeout() -> float:
    return float(os.environ.get("INFIMUM_WITNESS_TIMEOUT", "600"))


def iter_assignments(circuit, batch_values: list[dict],
                     processes: int | None = None):
    """Yield witness assignments for every batch, in order.

    `circuit` is a ProcessCircuit/TallyCircuit (anything with
    .assignment(values) -> list[int]); `batch_values` the per-batch circuit
    input dicts. Uses min(len(batches), cpu_count) forked workers; falls
    back to sequential in-process evaluation on platforms without fork or
    when a forked worker hangs (see module notes).
    """
    global _FORK_CIRCUIT, _FORK_BATCHES, FALLBACK_BATCHES
    n = len(batch_values)
    nproc = processes if processes is not None else min(n, os.cpu_count() or 1)
    if n <= 1 or nproc <= 1 or "fork" not in mp.get_all_start_methods():
        for v in batch_values:
            yield circuit.assignment(v)
        return
    _FORK_CIRCUIT, _FORK_BATCHES = circuit, batch_values
    pool = None
    done = 0
    try:
        ctx = mp.get_context("fork")
        pool = ctx.Pool(min(n, nproc))
        it = pool.imap(_eval_batch, range(n))
        timeout = _batch_timeout()
        while done < n:
            try:
                w = it.next(timeout)
            except mp.TimeoutError:
                # a worker hangs: kill the pool and finish the remaining
                # batches in-process
                print(f"[witness/parallel] worker timeout after {timeout}s "
                      f"on batch {done}; falling back to sequential for the "
                      f"remaining {n - done} batches", file=sys.stderr,
                      flush=True)
                pool.terminate()
                pool = None
                FALLBACK_BATCHES += n - done
                for v in batch_values[done:]:
                    yield circuit.assignment(v)
                return
            done += 1
            yield w
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        _FORK_CIRCUIT = _FORK_BATCHES = None


def parallel_assignments(circuit, batch_values: list[dict],
                         processes: int | None = None) -> list[list[int]]:
    """Witness assignments for every batch, preserving order (materialized;
    prefer iter_assignments for streaming consumers)."""
    return list(iter_assignments(circuit, batch_values, processes))
