"""The window's arithmetic: the rate over all proofs and all the time, the
p90 over all proofs, and a stall inside the window moving both."""

import bench_paths  # noqa: F401  (sys.path for the harness)

import pytest

from harness import spec, window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run_window(latencies, seconds):
    """A window of steps whose i-th proof takes latencies[i] seconds."""
    clock = FakeClock()

    def step(rec):
        clock.t += latencies[rec.index]
        rec.proved = rec.verified = rec.end = clock.t
        rec.ok = True

    records, start, end = window.closed_loop(step, 3, seconds, seed=7,
                                             clock=clock)
    return window.Run(records, start, end, setup_s=12.5)


def read(name, run):
    return spec.reader(name)(run)


def test_rate_and_p90_over_all_proofs():
    run = run_window([0.5] * 100, 10.0)
    assert len(run.records) == 20            # proofs start while it is open
    assert run.window_s == pytest.approx(10.0)
    assert read("proofs_per_s", run) == pytest.approx(2.0)
    assert read("proof_p90_s", run) == pytest.approx(0.5)
    assert read("setup_s", run) == 12.5
    assert [r.witness for r in run.records[:4]] == [0, 1, 2, 0]


def test_last_proof_started_in_the_window_counts_its_time():
    run = run_window([0.3] * 100, 1.0)      # 4 proofs, the last ends at 1.2
    assert len(run.records) == 4
    assert run.window_s == pytest.approx(1.2)
    assert read("proofs_per_s", run) == pytest.approx(4 / 1.2)


def test_a_stall_moves_the_rate_and_the_tail():
    steady = run_window([0.5] * 100, 10.0)
    lat = [0.5] * 100
    lat[3] = lat[9] = 3.0                    # two stalls among 16 proofs
    stalled = run_window(lat, 10.0)
    assert read("proofs_per_s", stalled) < read("proofs_per_s", steady)
    assert read("proof_p90_s", stalled) == pytest.approx(3.0)
    assert read("proof_p90_s", steady) == pytest.approx(0.5)


def test_failed_proofs_count_against_the_rate():
    clock = FakeClock()

    def step(rec):
        clock.t += 0.5
        rec.end = clock.t
        rec.ok = rec.index % 2 == 0

    records, start, end = window.closed_loop(step, 1, 10.0, 1, clock=clock)
    assert window.rate(records, end - start) == pytest.approx(1.0)


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert window.percentile(values, 0.9) == 90
    assert window.percentile([5.0], 0.9) == 5.0
    assert window.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 0.9) == 10
