"""The roofline count never falls below a hand-worked small case, and the
MSM share never reads above 100% for a kernel time at the bound."""

import bench_paths  # noqa: F401  (sys.path for the harness)

from collections import Counter

import pytest

from harness import spec, trace, window, yardstick
from harness.yardstick import bucket_adds


def test_hand_worked_bucket_count():
    # 10 scalars of 4 bits. c = 2: 2 windows of 10 digits, 2 buckets each,
    # (10 + 2 - 2) adds a window, joined by 2 doublings and an add: 23.
    # c = 4: one window, 10 + 8 - 2 = 16. c = 3: windows of 10 and 10
    # digits, 4 buckets: 12 + 12 + 4 = 28.
    # c = 1: 4 x 9 + 3 x 2 = 42. c >= 5: 10 + 2^(c-1) - 2 >= 24. Least: 16.
    assert bucket_adds(Counter({4: 10})) == 16
    # one scalar of 1 bit is its point: no addition; two need one
    assert bucket_adds(Counter({1: 1})) == 0
    assert bucket_adds(Counter({1: 2})) == 1
    assert bucket_adds(Counter()) == 0


def brute(bits):
    """The same count walked window by window, scalar by scalar."""
    lengths = [b for b, n in bits.items() for _ in range(n)]
    best = None
    for c in range(1, yardstick.MAX_WINDOW + 1):
        nwin = -(-max(lengths) // c)
        adds = (nwin - 1) * (c + 1)
        for w in range(nwin):
            d = sum(1 for b in lengths if b > w * c)
            if d:
                adds += d + 2 ** (c - 1) - 2
        best = adds if best is None else min(best, adds)
    return best


@pytest.mark.parametrize("bits", [Counter({254: 50}),
                                  Counter({1: 300, 64: 20, 254: 40}),
                                  Counter({250: 1000, 3: 1})])
def test_count_matches_the_walk(bits):
    assert bucket_adds(bits) == brute(bits)


def test_count_between_the_trivial_bounds():
    # no method sums n points in fewer than n - 1 additions; the bucket
    # method at its best window does no worse than at c = 1, where every
    # bit is a window
    for bits in (Counter({254: 4096}), Counter({1: 5000}),
                 Counter({16: 100, 254: 900})):
        live = sum(bits.values())
        top = max(bits)
        by_bit = sum(sum(n for b, n in bits.items() if b > w) - 1
                     for w in range(top)) + 2 * (top - 1)
        assert live - 1 <= bucket_adds(bits) <= by_bit


def test_least_time_and_share_at_the_bound():
    msms = [("g1", Counter({254: 1 << 16})), ("g2", Counter({254: 1 << 12}))]
    least = yardstick.proof_least_s(msms)
    ops_s = sum(bucket_adds(b) * yardstick.MULS_PER_ADD[c]
                for c, b in msms) / yardstick.INT32_MUL_PER_S
    assert least == pytest.approx(ops_s)     # these MSMs are bound by ops
    # kernels that ran exactly the least time read 100%
    ev = trace.Event("kernel", "msm_accum_kernel", 0.0, least)
    rec = window.ProofRecord(index=0, witness=0, seed=0, start=0, ok=True)
    run = window.Run([rec], 0.0, 1.0, 0.0, trace.Trace([ev], 0.0, 1.0),
                     proof_msms=lambda k: msms)
    assert spec.reader("msm_roofline")(run) == pytest.approx(100.0)


def test_peaks_and_product_counts():
    assert yardstick.INT32_MUL_PER_S == pytest.approx(16.727e12, rel=1e-3)
    assert yardstick.MULS_PER_PRODUCT == 264
    assert yardstick.MULS_PER_SQUARE == 208
    assert yardstick.MULS_PER_ADD == {"g1": 1528, "g2": 4488}


def test_live_scalars_follow_the_query_supports():
    from infimum_tpu_torch.groth16.r1cs import LC, ConstraintSystem

    cs = ConstraintSystem()
    out = cs.alloc_public()
    x, y, unused = cs.alloc(), cs.alloc(), cs.alloc()
    cs.enforce(LC.var(x), LC.var(y), LC.var(out))
    sup = yardstick.query_supports(cs)
    assert sup["a"] == {0, out, x}
    assert sup["b"] == {y}
    assert sup["l"] == {x, y}
    witness = [1, 6, 2, 3, 0]
    msms = yardstick.proof_msms(sup, witness, h_count=3)
    assert msms[0] == ("g1", Counter({1: 1, 3: 1, 2: 1}))
    assert msms[3] == ("g1", Counter({yardstick.H_BITS: 3}))
    assert msms[4][0] == "g2"
    assert unused not in sup["l"]
