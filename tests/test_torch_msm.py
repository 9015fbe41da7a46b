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
    B2, G1_GEN, G2_GEN, g1_add, g1_mul, g2_add, g2_mul, msm_host_fast,
)
from infimum_tpu.ff.bn254 import FQ_MOD, FR_MOD
from infimum_tpu_torch.msm import msm as M

torch.set_num_threads(1)  # the suite runs in parallel worker processes

CURVES = {"g1": (G1_GEN, g1_mul, g1_add), "g2": (G2_GEN, g2_mul, g2_add)}


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
    assert words("INF_FQ_P") == FQ_MOD
    assert words("INF_FQ_ONE") == R % FQ_MOD
    inv = int(re.search(r"#define INF_FQ_INV (0x[0-9a-f]+)u", src).group(1), 16)
    assert (inv * FQ_MOD) % (1 << 32) == (1 << 32) - 1
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
    scs = [0, 1, FR_MOD - 1, spec.n_buckets, spec.n_buckets + 1] \
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
    assert M.msm(pts, scs, curve) == msm_host_fast(pts, scs, curve)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_all_zero_and_empty(curve):
    gen = CURVES[curve][0]
    assert M.msm([gen, gen], [0, 0], curve) is None
    assert M.msm([], [], curve) is None


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
    """Every live emission fits the K = n_buckets + L + 2 slots, and the
    compacted digits are exactly the nonzero emitted digits per window."""
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
        assert torch.equal(cdig[w, :live.numel()], live.flatten())
        assert not cdig[w, live.numel():].any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MSM kernels run only on a card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernels_match_plain_on_card(cuda_device, curve):
    """Each kernel against its plain version on the same card tensors."""
    spec = M.SPECS[curve]
    n, lanes = 4096, 128
    rows, sc = M.encode_inputs(_points(curve, 41, n), _ints(42, n), lanes,
                               curve, cuda_device)
    args = M.lane_layout(rows, sc, lanes, spec)
    K = spec.n_buckets + lanes + 2
    kd, kp = M.compact(*M.accumulate(*args, spec), K)
    pd, pp = M.compact(*M.accumulate_plain(*args, spec), K)
    assert torch.equal(kd, pd)
    assert torch.equal(kp, pp)     # same formulas, same order: same limbs
    kw = M.weighted_sum(kd, kp, spec)
    pw = M.weighted_sum_plain(pd, pp, spec)
    assert (M.decode_windows(M.words_to_limbs(kw).cpu(), curve)
            == M.decode_windows(M.words_to_limbs(pw).cpu(), curve))
