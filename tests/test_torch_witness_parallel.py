"""The port's forked witness workers (infimum_tpu_torch.witness.parallel)
against in-process evaluation and the reference's workers.

On the TallyCircuit(2, 1, 1) batches of tests/test_parallel.py: the forked
assignments equal the sequential ones and the reference's
`parallel_assignments` on the same inputs; `processes=1` takes the
sequential path without forking; a worker that stalls past
INFIMUM_WITNESS_TIMEOUT sends the remaining batches back to this process,
with the same witnesses, and FALLBACK_BATCHES counts them. Every
comparison is exact."""

import os
import random
import time

import pytest

from infimum_tpu.circuits.tally import TallyCircuit as RefTally
from infimum_tpu.witness import tally as ref_tally
from infimum_tpu.witness.parallel import parallel_assignments as ref_parallel
from infimum_tpu_torch.circuits.tally import TallyCircuit
from infimum_tpu_torch.witness import parallel, tally


def _batches(circuit_cls, mod):
    tc = circuit_cls(state_tree_depth=2, int_state_tree_depth=1,
                     vote_option_tree_depth=1)
    ballots = [mod.Ballot(nonce=1, votes=[1, 0, 2, 0, 0]) for _ in range(4)]
    tb = mod.TallyWitnessBuilder(tc, state_root=123, sb_salt=7,
                                 ballots=ballots, num_signups=4)
    rng = random.Random(3)
    values = [tb.batch_inputs(rng)[0] for _ in range(tb.num_batches)]
    assert len(values) >= 2
    return tc, values


@pytest.fixture(scope="module")
def port_batches():
    return _batches(TallyCircuit, tally)


class _Stalls:
    """A circuit whose assignment hangs in a forked child, as a worker
    deadlocked on a lock would."""

    def __init__(self, circuit):
        self.circuit, self.parent = circuit, os.getpid()

    def assignment(self, values):
        if os.getpid() != self.parent:
            time.sleep(600)
        return self.circuit.assignment(values)


def test_parallel_matches_sequential_and_reference(port_batches):
    tc, values = port_batches
    seq = [tc.assignment(v) for v in values]
    fell = parallel.FALLBACK_BATCHES
    assert parallel.parallel_assignments(tc, values, processes=2) == seq
    assert parallel.FALLBACK_BATCHES == fell
    assert ref_parallel(*_batches(RefTally, ref_tally), processes=2) == seq


def test_one_process_takes_the_sequential_path(port_batches, monkeypatch):
    tc, values = port_batches

    def no_fork(*a, **k):
        raise AssertionError("forked with processes=1")

    monkeypatch.setattr(parallel.mp, "get_context", no_fork)
    assert parallel.parallel_assignments(tc, values, processes=1) == [
        tc.assignment(v) for v in values]


def test_worker_timeout_falls_back_and_counts(port_batches, monkeypatch):
    tc, values = port_batches
    monkeypatch.setenv("INFIMUM_WITNESS_TIMEOUT", "0.5")
    fell = parallel.FALLBACK_BATCHES
    got = parallel.parallel_assignments(_Stalls(tc), values, processes=2)
    assert got == [tc.assignment(v) for v in values]
    assert parallel.FALLBACK_BATCHES == fell + len(values)
