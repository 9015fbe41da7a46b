"""Port MSM pipeline (infimum_tpu_torch.msm.msm) against host ground truth.

The reference Pallas MSM is not run here: its interpret mode takes longer
than the whole suite's limit on a CPU. The pipeline (recode, sort, the
kernels' plain versions, compaction, Horner) is held against the host
Pippenger `msm_host_fast`, and each window against a host sum of digit * P
under the same signed recode. Points are compared as affine points.
The kernels themselves run only on a card (`cuda` marker)."""

import re
import pathlib

import numpy as np
import pytest
import torch

from infimum_tpu.curve.bn254_host import (
    B2, G1_GEN, G2_GEN, g1_add, g1_mul, g1_neg, g2_add, g2_mul, g2_neg,
    msm_host_fast,
)
from infimum_tpu.ff.bn254 import FQ_MOD, FR_MOD
from infimum_tpu_torch.msm import msm as M

torch.set_num_threads(1)  # the suite runs in parallel worker processes

CURVES = {"g1": (G1_GEN, g1_mul, g1_add), "g2": (G2_GEN, g2_mul, g2_add)}
NEG = {"g1": g1_neg, "g2": g2_neg}


def _ints(seed, n, bits=254, mod=FR_MOD):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row))
            % (1 << bits) % mod for row in words]


def _points(curve, seed, n):
    gen, mul, _ = CURVES[curve]
    return [mul(gen, k or 1) for k in _ints(seed, n, bits=64)]


def _signed_digits(s, spec):
    """Host signed recode of one scalar: [(magnitude, negative)] per window."""
    out, carry = [], 0
    for w in range(spec.n_windows):
        d = ((s >> (spec.c_bits * w)) & ((1 << spec.c_bits) - 1)) + carry
        neg = d > spec.n_buckets
        out.append((2 * spec.n_buckets - d if neg else d, neg))
        carry = int(neg)
    return out


def test_field_header_constants():
    """csrc/field.cuh's literal constants are the Python values."""
    src = (pathlib.Path(M.__file__).parents[1] / "csrc" / "field.cuh") \
        .read_text().replace("\\\n", " ")

    def words(name):
        body = re.search(rf"#define {name} \{{([^}}]*)\}}", src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    R = 1 << 256
    for field, mod in (("FQ", FQ_MOD), ("FR", FR_MOD)):
        assert words(f"INF_{field}_P") == mod
        assert words(f"INF_{field}_ONE") == R % mod
        inv = int(re.search(rf"#define INF_{field}_INV (0x[0-9a-f]+)u",
                            src).group(1), 16)
        assert (inv * mod) % (1 << 32) == (1 << 32) - 1
    assert words("INF_G2_B3_C0") == 3 * B2[0] * R % FQ_MOD
    assert words("INF_G2_B3_C1") == 3 * B2[1] * R % FQ_MOD


def test_limb_word_roundtrip():
    limbs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 16, size=(5, 32), dtype=np.int64))
    words = M.limbs_to_words(limbs)
    assert words.dtype == torch.int32
    assert torch.equal(M.words_to_limbs(words), limbs)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_recode_reconstructs_scalar(curve):
    spec = M.SPECS[curve]
    c, half = spec.c_bits, spec.n_buckets
    carried = (half + 1) + (half << c) + (half << 2 * c)   # carry passes on
    scs = [0, 1, FR_MOD - 1, half, half + 1, carried, carried << 5 * c] \
        + _ints(4, 11)
    mags, sgns = M.recode(M.ints_to_tensor(scs, "cpu"), spec)
    for i, s in enumerate(scs):
        total = sum((-1 if sgns[w, i] else 1) * int(mags[w, i])
                    << (spec.c_bits * w) for w in range(spec.n_windows))
        assert total == s
        assert [(int(mags[w, i]), bool(sgns[w, i]))
                for w in range(spec.n_windows)] == _signed_digits(s, spec)
        assert int(mags[:, i].max()) <= spec.n_buckets


@pytest.mark.parametrize("curve,n", [("g1", 1), ("g1", 100), ("g1", 250),
                                     ("g2", 2), ("g2", 100), ("g2", 250)])
def test_msm_matches_host(curve, n):
    pts = _points(curve, n, n)
    scs = _ints(100 + n, n)
    if n > 3:
        scs[0] = 0                      # zero scalar
        scs[1] = FR_MOD - 1             # r - 1
        pts[3] = pts[2]                 # duplicate points...
        scs[3] = scs[2]                 # ...with the same digits
    lanes = M.msm_lanes(n, curve)
    assert n % lanes                # padding path: n not a lane multiple
    assert M.msm(pts, scs, curve, "cpu") == msm_host_fast(pts, scs, curve)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_all_zero_and_empty(curve):
    gen = CURVES[curve][0]
    assert M.msm([gen, gen], [0, 0], curve, "cpu") is None
    assert M.msm([], [], curve, "cpu") is None


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_window_sums_match_host(curve):
    spec = M.SPECS[curve]
    gen, mul, add = CURVES[curve]
    n = 40
    pts = _points(curve, 17, n)
    scs = _ints(18, n)
    pts[5] = pts[6]
    lanes = 8
    rows, sc = M.encode_inputs(pts, scs, lanes, curve)
    got = M.decode_windows(M.msm_rows_async(rows, sc, lanes, curve), curve)
    digits = [_signed_digits(s, spec) for s in scs]
    for w in range(spec.n_windows):
        want = None
        for p, ds in zip(pts, digits):
            mag, neg = ds[w]
            if mag:
                want = add(want, mul(p, FR_MOD - mag if neg else mag))
        assert got[w] == want, w


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_emissions_compact_within_bound(curve):
    """Every live emission fits the K = n_buckets + L + 2 slots, and each
    window's compacted digits, taken lane by lane, are non-decreasing and
    the same multiset as its nonzero emitted digits, then zero padding."""
    spec = M.SPECS[curve]
    n, lanes = 64, 8
    rows, sc = M.encode_inputs(_points(curve, 31, n), _ints(32, n), lanes,
                               curve)
    T, nwin = n // lanes, spec.n_windows
    edig, ept = M.accumulate(*M.lane_layout(rows, sc, lanes, spec), spec)
    assert edig.shape == (nwin, T + 1, lanes)
    assert ept.shape == (nwin, T + 1, spec.PW, lanes)
    K = spec.n_buckets + lanes + 2
    cdig, cpts = M.compact(edig, ept, K)
    for w in range(nwin):
        live = edig[w][edig[w] > 0]
        got = cdig[w, :live.numel()]
        assert (got > 0).all()
        assert (got[1:] >= got[:-1]).all()
        assert torch.equal(got.sort().values, live.sort().values)
        assert not cdig[w, live.numel():].any()


def _gather_case(case):
    """One edge case of the accumulation's gather: (windows, lanes), each
    window a list of L*T sorted (digit, negative, table row) entries over a
    table of 4 points and 12 zero padding rows."""
    L, T = 4, 4
    pad = list(range(4, 16))                   # the zero padding rows
    zeros = [(0, False, r) for r in pad]
    if case == "all_zero":
        return [[(0, False, r) for r in range(16)]], L
    if case == "one_live_lane":               # lanes 0-2 zero, lane 3 live
        return [zeros + [(2, False, 0), (2, True, 1), (5, False, 2),
                         (9, True, 3)]], L
    if case == "run_across_lanes":            # digit 4 runs from lane 1 into 2
        live = [(1, False, 0), (3, True, 1)] + [
            (4, i % 2 == 1, i % 4) for i in range(7)] + [
            (6, False, 2), (6, True, 3), (7, False, 1)]
        return [[(0, False, 4), (0, False, 5), (0, False, 6),
                 (0, False, 7)] + live], L
    if case == "repeated_point":              # P + P through the mixed add
        return [zeros[:10] + [(3, False, 1), (3, False, 1), (3, False, 2),
                              (8, True, 0), (8, True, 0), (8, True, 0)]], L
    if case == "cancel":                      # P and -P in one bucket
        return [zeros[:11] + [(5, False, 2), (5, True, 2), (6, False, 0),
                              (6, True, 0), (7, True, 3)],
                zeros[:12] + [(2, False, 1), (2, True, 1), (2, False, 1),
                              (2, True, 1)]], L
    if case == "padding_rows":                # order reaches the padding rows
        return [[(0, False, r) for r in reversed(pad)] + [
            (1, False, 3), (1, False, 0), (2, True, 1), (2, False, 2)],
                zeros[:8] + [(d, d % 3 == 0, d % 4) for d in range(1, 9)]], L
    raise ValueError(case)


GATHER_CASES = ["all_zero", "one_live_lane", "run_across_lanes",
                "repeated_point", "cancel", "padding_rows"]


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_accumulate_gather_matches_host(curve, case):
    """The accumulation's plain version, reading each entry's point from
    the row-major table through `order`, then compaction and the weighted
    reduction: each window against a host sum of digit * (+-P)."""
    spec = M.SPECS[curve]
    _, mul, add = CURVES[curve]
    windows, L = _gather_case(case)
    pts = _points(curve, 61, 4)
    rows = M.encode_rows(pts, 16, curve)            # 4 points, 12 zero rows
    assert rows.shape[0] == 16 and not rows[4:].any()
    T = 16 // L

    def field(i):
        return torch.tensor([[e[i] for e in w] for w in windows],
                            dtype=torch.int32).view(len(windows), L, T)

    sdig, ssgn, order = field(0), field(1), field(2)
    edig, ept = M.accumulate(sdig, ssgn, order, M.limbs_to_words(rows), spec)
    assert edig.shape == (len(windows), T + 1, L)
    cdig, cpts = M.compact(edig, ept, spec.n_buckets + L + 2)
    got = M.decode_windows(M.words_to_limbs(
        M.weighted_sum_plain(cdig, cpts, spec)), curve)
    for w, entries in enumerate(windows):
        assert [d for d, _, _ in entries] == sorted(d for d, _, _ in entries)
        want = None
        for d, neg, r in entries:
            if d:
                want = add(want, mul(NEG[curve](pts[r]) if neg else pts[r], d))
        assert got[w] == want, w
    if case in ("all_zero", "cancel"):
        assert got[-1] is None


def _window_inputs(curve, windows, K):
    """Windows of (digit, host point) lists, digits non-decreasing -> the
    weighted kernel's (cdig, cpts) as compaction lays them out."""
    spec = M.SPECS[curve]
    cdig = torch.zeros((len(windows), K), dtype=torch.int32)
    cpts = torch.zeros((len(windows), spec.PW, K), dtype=torch.int32)
    for w, entries in enumerate(windows):
        if not entries:
            continue
        digits = [d for d, _ in entries]
        assert digits == sorted(digits) and len(digits) <= K
        aff = spec.curve.encode_affine([p for _, p in entries])
        one = spec.curve.one((len(entries),), "cpu")
        cdig[w, :len(entries)] = torch.tensor(digits, dtype=torch.int32)
        cpts[w, :, :len(entries)] = M._point_words(
            (aff[:, 0], aff[:, 1], one), spec).T
    return cdig, cpts


def _weighted_cases(curve, case):
    """The windows of one edge case of the chunked running sum."""
    spec = M.SPECS[curve]
    C, nb = spec.chunk, spec.n_buckets
    pts = _points(curve, 51, 2 * C + 5)
    p, q = pts[0], pts[1]
    if case == "empty":
        return [[]]
    if case == "one_entry":
        return [[(5, p)]]
    if case == "same_digit":
        return [[(9, x) for x in pts[:2 * C + 1]]]
    if case == "largest_gap":
        return [[(1, p), (1, q), (nb, pts[2]), (nb, pts[3])], [(1, p), (nb, q)]]
    if case == "run_across_chunks":
        digits = [1] * (C - 2) + [7] * 4 + [8] * (C - 2)
        return [list(zip(digits, pts))]
    if case == "cancel":
        negp = NEG[curve](p)
        return [[(3, p), (3, negp)], [(2, q), (3, p), (3, negp), (4, q)]]
    if case == "double":
        return [[(5, p), (5, p)], [(4, p), (6, p)]]
    if case == "ragged":
        digits = sorted(int(d) for d in np.random.default_rng(52).integers(
            1, nb + 1, size=2 * C + 5))
        return [list(zip(digits, pts))]
    raise ValueError(case)


WEIGHTED_CASES = ["empty", "one_entry", "same_digit", "largest_gap",
                  "run_across_chunks", "cancel", "double", "ragged"]


@pytest.mark.parametrize("case", WEIGHTED_CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_weighted_chunks_match_host(curve, case):
    """The chunked running sum (the kernel's plain version) against a host
    sum of digit * point per window, at the edges of its algorithm."""
    spec = M.SPECS[curve]
    _, mul, add = CURVES[curve]
    windows = _weighted_cases(curve, case)
    K = 3 * spec.chunk + 7          # not a multiple of the chunk
    cdig, cpts = _window_inputs(curve, windows, K)
    got = M.decode_windows(M.words_to_limbs(
        M.weighted_sum_plain(cdig, cpts, spec)), curve)
    for w, entries in enumerate(windows):
        want = None
        for d, p in entries:
            want = add(want, mul(p, d))
        assert got[w] == want, w
    if case in ("cancel", "empty"):
        assert got[0] is None


def test_weighted_grid_fills_card():
    """At the main path's shapes (the reference process key's `a` query:
    4,096 lanes, G1; `b2`: 2,048 lanes, G2) the kernel's first launch has
    at least one block per SM of an H100 (132)."""
    for curve, lanes in (("g1", 4096), ("g2", 2048)):
        spec = M.SPECS[curve]
        K = spec.n_buckets + lanes + 2
        assert M.weighted_blocks(K, spec) * spec.n_windows >= 132


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_weighted_chunk_matches_kernel(curve):
    """The chunk the plain version and the scratch buffer's size use is the
    kernel's compiled-in chunk for the curve."""
    src = (pathlib.Path(M.__file__).parents[1] / "csrc"
           / "msm_weighted.cu").read_text()
    chunk = re.search(rf"constexpr int CHUNK_{curve.upper()} = (\d+);", src)
    assert int(chunk.group(1)) == M.SPECS[curve].chunk


def _cuda_body(src: str, head: str) -> str:
    """The body of the first definition in `src` whose text starts with
    `head`, up to its matching brace."""
    start = src.index("{", src.index(head))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise ValueError(head)


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("formula,table", [("rcb_add", "ADD_MULS"),
                                           ("rcb_add_mixed", "MIXED_MULS")])
def test_bound_counts_kernel_products(formula, table, curve):
    """The Fq products a complete or mixed add costs in the smoke's bound
    are those of `field.cuh`: its F::mul and F::b3 calls, each F::mul one
    Fq product over Fq and Fq2's Karatsuba 3 over Fq2, each F::b3 additions
    over Fq and one Fq2 product by the constant over Fq2."""
    import chip_smoke

    src = (pathlib.Path(M.__file__).parents[1] / "csrc"
           / "field.cuh").read_text()
    assert _cuda_body(src, "// Karatsuba: 3 Fq products").count(
        "Fq::mul(") == 3
    fp_b3 = _cuda_body(src, "// 9x = 3b * x for G1")
    assert "mul(" not in fp_b3
    fq2_b3 = _cuda_body(src[src.index("struct Fq2OutOfLine"):],
                        "static __device__ __forceinline__ E b3(")
    assert fq2_b3.count("mul(") == 1
    body = _cuda_body(src, f"__device__ __forceinline__ Proj<F> {formula}(")
    muls, b3s = body.count("F::mul("), body.count("F::b3(")
    want = muls if curve == "g1" else 3 * muls + 3 * b3s
    assert getattr(chip_smoke, table)[curve] == want


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_weighted_adds_count(curve):
    """`chip_smoke.weighted_adds` counts the chunk walks' adds as a walk
    over the digits does, and the sums of the live chunks' values."""
    import chip_smoke

    spec = M.SPECS[curve]
    C = spec.chunk
    digits = sorted(int(d) for d in np.random.default_rng(53).integers(
        1, spec.n_buckets + 1, size=3 * C + 2))
    cdig = torch.zeros((2, 5 * C), dtype=torch.int32)
    cdig[0, :len(digits)] = torch.tensor(digits, dtype=torch.int32)
    cdig[1, :C] = 3

    def cost(g):
        return g.bit_length() + bin(g).count("1") - 1 if g else 0

    def cost_w2(g):
        wins = [(g >> (2 * i)) & 3 for i in range((g.bit_length() + 1) // 2)]
        return 2 + 2 * (len(wins) - 1) + sum(w > 0 for w in wins[:-1]) + 1

    want = 0
    for row in cdig.tolist():
        for c in range(0, len(row), C):
            live = [d for d in row[c:c + C] if d]
            if live:
                want += len(live) - 1 + cost_w2(live[0]) + sum(
                    cost(b - a) for a, b in zip(live, live[1:]))
    assert chip_smoke.weighted_adds(cdig, spec) == {"chunks": want,
                                                     "sums": 3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MSM kernels run only on a card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernels_match_plain_on_card(cuda_device, curve):
    """Each kernel against its plain version on the same card tensors, at
    a shape with several chunks and several blocks per window; the window
    sums of both combine to the host MSM through the native library's
    Horner."""
    spec = M.SPECS[curve]
    n, lanes = 4096, 128
    pts, scs = _points(curve, 41, n), _ints(42, n)
    rows, sc = M.encode_inputs(pts, scs, lanes, curve, cuda_device)
    args = M.lane_layout(rows, sc, lanes, spec)
    K = spec.n_buckets + lanes + 2
    kd, kp = M.compact(*M.accumulate(*args, spec), K)
    pd, pp = M.compact(*M.accumulate_plain(*args, spec), K)
    assert torch.equal(kd, pd)
    assert torch.equal(kp, pp)     # same formulas, same order: same limbs
    live = int((kd != 0).sum(1).max())
    assert live > M.CHUNKS_PER_BLOCK * spec.chunk   # chunks of 2+ blocks
    assert M.weighted_blocks(K, spec) > 2
    kw = M.words_to_limbs(M.weighted_sum(kd, kp, spec)).cpu()
    pw = M.words_to_limbs(M.weighted_sum_plain(pd, pp, spec)).cpu()
    assert M.decode_windows(kw, curve) == M.decode_windows(pw, curve)
    want = msm_host_fast(pts, scs, curve)
    assert M.combine_window_points(kw, curve) == want
    assert M.combine_window_points(pw, curve) == want


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_accumulate_kernel_multi_wave_on_card(cuda_device, curve):
    """The accumulation kernel against its plain version at 2^15 points and
    the curve's most lanes, a grid of more blocks than the card holds at
    once: equal emitted digits, and equal limbs after compaction."""
    from infimum_tpu_torch import kernels

    spec = M.SPECS[curve]
    n, lanes = 1 << 15, M.LANES_MAX[curve]
    pts = _points(curve, 71, 64) * (n // 64)
    rows, sc = M.encode_inputs(pts, _ints(72, n), lanes, curve, cuda_device)
    args = M.lane_layout(rows, sc, lanes, spec)
    ked, kep = M.accumulate(*args, spec)
    ped, pep = M.accumulate_plain(*args, spec)
    assert torch.equal(ked, ped)
    K = spec.n_buckets + lanes + 2
    kd, kp = M.compact(ked, kep, K)
    pd, pp = M.compact(ped, pep, K)
    assert torch.equal(kd, pd)
    assert torch.equal(kp, pp)
    block, per_sm = kernels.accum_occupancy(curve)
    blocks = spec.n_windows * lanes // block
    resident = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    assert blocks > resident
