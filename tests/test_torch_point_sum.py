"""The sharded MSM's cross-rank sum (infimum_tpu_torch.parallel.msm
`point_sum`, csrc/point_sum.cu) against the JAX package's
`_tree_reduce_axis0` and host affine sums, on the CPU, with no process
group.

D = 1, 2, 3, 4, 5, 7, 8 and 16 projective points a window (33 and 64
for the levels through the scratch), G1 and G2, each a random projective
scaling of an affine point, with windows of infinity entries (two forms
of it), a point plus itself and a point plus its negation. The kernel's
schedule (its halving levels, each complete add split over a warp's
lanes in RCB Alg. 7's steps, every value through the warp's slots) is
modelled lane by lane with the port's torch Fq ops and held against the
plain version bit for bit. The kernel itself runs only on a card (`cuda`
marker)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from infimum_tpu.curve.bn254_host import (
    fixed_base_mul_host, g1_add, g1_neg, g2_add, g2_neg,
)
from infimum_tpu.curve.proj import G1_DEV as REF_G1, G2_DEV as REF_G2
from infimum_tpu.ff.bn254 import FQ_MOD
from infimum_tpu.parallel.msm import _tree_reduce_axis0 as ref_reduce

from infimum_tpu_torch.ff.fp import FQ_CTX, limbs_to_words, words_to_limbs
from infimum_tpu_torch.msm.msm import SPECS
from infimum_tpu_torch.parallel import msm as PM

torch.set_num_threads(1)  # the suite runs in parallel worker processes

HOST = {"g1": (g1_add, g1_neg), "g2": (g2_add, g2_neg)}
REF = {"g1": REF_G1, "g2": REF_G2}
DS = (1, 2, 3, 4, 5, 7, 8, 16)


def _case(curve: str, d: int, seed: int):
    """(host affine points [d][nwin] with None for infinity, (d, nwin, PW)
    projective words of them). Window 0: all infinity; window 1: entry 1
    equals entry 0; window 2: entry 1 is entry 0's negation; the rest
    from the seed. Every point is scaled by a random lambda in Fq (Z =
    lambda); half the infinities are (0, lambda, 0), half (0, 1, 0)."""
    spec = SPECS[curve]
    nwin = spec.n_windows
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(d * nwin)]
    pts = fixed_base_mul_host(ks, curve)
    grid = [pts[i * nwin:(i + 1) * nwin] for i in range(d)]
    for i in range(d):
        grid[i][0] = None
    if d >= 2:
        grid[1][1] = grid[0][1]
        grid[1][2] = HOST[curve][1](grid[0][2])
    cdev = spec.curve
    flat = [p if p is not None else cdev.gen for row in grid for p in row]
    aff = cdev.encode_affine(flat, "cpu")            # (d nwin, 2, fshape)
    lam = FQ_CTX.encode([int(rng.integers(1, 1 << 62)) % FQ_MOD
                         for _ in range(d * nwin)], "cpu")
    # lambda as a field element of the curve: (lam, 0) in Fq2
    z = lam if cdev.fdims == 1 else torch.stack([lam, torch.zeros_like(lam)],
                                                1)
    x, y = (cdev.F.mont_mul(aff[:, i], z) for i in (0, 1))
    one = cdev.one((), "cpu")
    for j, p in enumerate(p for row in grid for p in row):
        if p is None:
            y[j] = one if j % 2 else z[j]
            x[j] = 0
    z = z.clone()
    z[[p is None for row in grid for p in row]] = 0
    words = limbs_to_words(torch.cat([c.flatten(1) for c in (x, y, z)], 1))
    return grid, words.reshape(d, nwin, spec.PW).contiguous()


def _host_sums(curve, grid):
    add = HOST[curve][0]
    out = []
    for w in range(len(grid[0])):
        acc = None
        for row in grid:
            acc = add(acc, row[w])
        out.append(acc)
    return out


def _decode(curve, words):
    spec = SPECS[curve]
    limbs = words_to_limbs(words).unflatten(-1, (3, *spec.curve.fshape()))
    return spec.curve.decode((limbs[:, 0], limbs[:, 1], limbs[:, 2]))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_sum_matches_reference(curve, d):
    """point_sum (the plain version here) equals, as affine points, the
    JAX package's `_tree_reduce_axis0` on the same limbs and the host sum
    of the affine points."""
    grid, words = _case(curve, d, seed=100 * d + len(curve))
    got = PM.point_sum(words, curve)
    assert got.shape == (SPECS[curve].n_windows, SPECS[curve].PW)
    mine = _decode(curve, got)
    assert mine == _host_sums(curve, grid)
    assert mine[0] is None                       # all infinity
    if d >= 2:                                   # P + P, P + (-P)
        assert mine[1] is not None
    ref = REF[curve]
    limbs = words_to_limbs(words).unflatten(-1, (3, *ref.fshape()))
    pts = tuple(np.asarray(limbs[:, :, i].numpy(), dtype=np.uint32)
                for i in range(3))
    assert ref.decode(ref_reduce(ref, pts)) == mine


def _old_limbs_path(curve, words):
    """The sum as the gather mode ran it before it kept the words: limbs,
    the plain tree, limbs back to words."""
    spec = SPECS[curve]
    cdev = spec.curve
    every = words_to_limbs(words)
    w = every.unflatten(-1, (3, *cdev.fshape()))
    pt = tuple(w.select(every.dim() - 1, i) for i in range(3))
    total = PM._tree_reduce_axis0(cdev, pt)
    return limbs_to_words(torch.stack(total, 1).reshape(total[0].shape[0],
                                                        spec.PR))


# csrc/point_sum.cu's value slots (Slots<K>): G1 a slot a value; G2 a
# slot an Fq component or a Karatsuba part
SLOTS = {1: dict(P=0, T3=6, T4=7, Y3=8, T0x3=9, B=10, Z3=12, T1n=13, Y3b=11,
                 Q=14),
         2: dict(P=18, T3=30, T4=32, Y3=34, T0x3=36, B=38, Z3=44, T1n=46,
                 Y3b=48, Q=50)}


def _warp_add(K, p, q):
    """One complete add as the kernel's warp runs it (`warp_add`), lane by
    lane and step by step, each lane's value through the warp's slots:
    p, q are lists of 3 K Fq limb tensors (nwin, 16), coordinate-major
    (X, Y, Z), component-minor (c0, c1); returns P + Q the same way."""
    F = FQ_CTX
    S = SLOTS[K]
    parts = 1 if K == 1 else 3
    s = {}

    def sp(j, c):                       # Slots<K>::p: P_j, component c
        return S["P"] + (j if K == 1 else 2 * j + c)

    def joined(base, c):                # a Karatsuba product's component
        x = s[base + (2 if c else 0)]
        if c:
            x = F.sub(x, s[base])
        return F.sub(x, s[base + 1])

    def first_operand(pt, j, k):
        ca, cb = (j if j < 3 else (1 if j == 4 else 0)), (1 if j == 3 else 2)

        def part(c):
            x = pt[ca * K + c]
            if j >= 3:
                x = F.add(x, pt[cb * K + c])
            return x
        if K == 1:
            return part(0)
        x = part(0 if k == 2 else k)
        return F.add(x, part(1)) if k == 2 else x

    for lane in range(6 * parts):       # 1. the first products
        j, k = divmod(lane, parts)
        s[S["P"] + j if K == 1 else 3 * j + k] = F.mont_mul(
            first_operand(p, j, k), first_operand(q, j, k))
    if K == 2:                          # the parts joined into P_j
        for lane in range(12):
            s[sp(lane >> 1, lane & 1)] = joined(3 * (lane >> 1), lane & 1)
    for lane in range(4 * K):           # 2. t3, t4, y3, t0x3
        u, c = divmod(lane, K)
        x, y, z = (3, 4, 5, 0)[u], (0, 1, 0, 0)[u], (1, 2, 2, 0)[u]
        t = F.add(s[sp(y, c)], s[sp(z, c)])
        s[S["T3"] + K * u + c] = (F.sub(s[sp(x, c)], t) if u < 3
                                  else F.add(t, s[sp(x, c)]))
    if K == 1:                          # 3. B0 = 3b P2, B1 = 3b y3
        for lane in range(2):
            x = s[S["Y3"] if lane else sp(2, 0)]
            x2 = F.add(x, x)
            x4 = F.add(x2, x2)
            s[S["B"] + lane] = F.add(F.add(x4, x4), x)
    else:
        k0, k1 = SPECS["g2"].curve.b3("cpu").unbind(0)   # 3 b2, (c0, c1)
        for lane in range(6):
            which, k = divmod(lane, 3)
            x = S["Y3"] if which else sp(2, 0)
            a, b = s[x + (k == 1)], (k1 if k == 1 else k0)
            if k == 2:
                a, b = F.add(a, s[x + 1]), F.add(k0, k1)
            s[S["B"] + lane] = F.mont_mul(a, b.expand_as(a))
    for lane in range(2 if K == 1 else 6):  # 4. Z3, t1n (Y3b)
        u, c = divmod(lane, K)
        b = s[S["B"]] if K == 1 else joined(S["B"] + (3 if u == 2 else 0), c)
        t1 = s[sp(1, c)]
        s[S["Z3"] + K * u + c] = (F.add(t1, b) if u == 0 else
                                  F.sub(t1, b) if u == 1 else b)
    ops = [("T4", "Y3b"), ("T3", "T1n"), ("Y3b", "T0x3"), ("T1n", "Z3"),
           ("T0x3", "T3"), ("Z3", "T4")]
    for lane in range(6 * parts):       # 5. the last products
        j, k = divmod(lane, parts)
        ia, ib = (S[n] for n in ops[j])
        a, b = s[ia + (k == 1)], s[ib + (k == 1)]
        if k == 2:
            a, b = F.add(a, s[ia + 1]), F.add(b, s[ib + 1])
        s[S["Q"] + (j if K == 1 else lane)] = F.mont_mul(a, b)
    out = [None] * (3 * K)
    for lane in range(3 * K):           # 6. X3, Y3, Z3
        o, c = divmod(lane, K)
        hi, lo = ((s[S["Q"] + 2 * o + 1], s[S["Q"] + 2 * o]) if K == 1 else
                  (joined(S["Q"] + 3 * (2 * o + 1), c),
                   joined(S["Q"] + 3 * (2 * o), c)))
        out[o * K + c] = F.sub(hi, lo) if o == 0 else F.add(hi, lo)
    return out


def _kernel_schedule(curve, words):
    """The kernel's schedule, modelled with the port's torch Fq ops: T =
    2 half >= D; the first level adds input i and i + half (infinity (0,
    1, 0) at or above D), each level after it entry i and i + h of the
    level before, every add `_warp_add`; a level of more than
    `LEVEL_POINTS` points goes to the scratch, a smaller one to shared
    memory, the last to the output. At D = 1 the wrapper launches nothing
    and returns the entry. Returns (words, the levels' places)."""
    spec = SPECS[curve]
    K = spec.curve.fdims
    d, nwin = words.shape[:2]
    if d == 1:
        return words[0].clone(), []
    limbs = words_to_limbs(words)                     # (d, nwin, 3 K 16)
    entry = [list(limbs[i].reshape(nwin, 3 * K, 16).unbind(1))
             for i in range(d)]
    zero = torch.zeros_like(entry[0][0])
    infinity = [zero] * (3 * K)
    infinity[K] = FQ_CTX.one((nwin,), "cpu")
    half = 1
    while 2 * half < d:
        half *= 2
    places = []

    def place(h):
        return "out" if h == 1 else (
            "scratch" if h > PM.LEVEL_POINTS else "shared")
    level = [_warp_add(K, entry[i], entry[i + half] if i + half < d
                       else infinity) for i in range(half)]
    places.append(place(half))
    h = half // 2
    while h >= 1:
        for i in range(h):              # entry i read, then written
            level[i] = _warp_add(K, level[i], level[i + h])
        places.append(place(h))
        h //= 2
    out = torch.stack(level[0], 1).reshape(nwin, 3 * K * 16)
    return limbs_to_words(out), places


def test_level_points_match_kernel():
    """The wrapper's LEVEL_POINTS (it allocates the scratch only above
    it) is the kernel's kLevelPoints."""
    src = (pathlib.Path(PM.__file__).parents[1] / "csrc" / "point_sum.cu"
           ).read_text()
    assert int(re.search(r"constexpr int kLevelPoints = (\d+);", src
                         ).group(1)) == PM.LEVEL_POINTS


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_sum_bits(curve, d):
    """The words-in, words-out sum equals the limbs path it replaced bit
    for bit, and so does the kernel's walk over the levels; the permute
    round (D = 2) is the complete add of mine and my partner's."""
    _, words = _case(curve, d, seed=7 * d + len(curve))
    got = PM.point_sum(words, curve)
    assert got.dtype == torch.int32
    assert torch.equal(got, _old_limbs_path(curve, words))
    model, places = _kernel_schedule(curve, words)
    assert torch.equal(model, got)
    levels = (d - 1).bit_length()                 # log2 T
    assert places == ["shared"] * (levels - 1) + ["out"] * (d > 1)
    if d == 2:
        cdev = SPECS[curve].curve
        limbs = words_to_limbs(words).unflatten(-1, (3, *cdev.fshape()))
        pair = cdev.add(*(tuple(limbs[i, :, k] for k in range(3))
                          for i in range(2)))
        assert torch.equal(got, limbs_to_words(
            torch.cat([c.flatten(1) for c in pair], 1)))


@pytest.mark.parametrize("d", [33, 64])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_schedule_scratch_levels(curve, d):
    """Above 32 points a window the first levels (more than LEVEL_POINTS
    points) go through the scratch: the schedule still equals the plain
    version bit for bit."""
    _, words = _case(curve, d, seed=5 * d + len(curve))
    model, places = _kernel_schedule(curve, words)
    assert torch.equal(model, PM.point_sum_plain(words, curve))
    levels = (d - 1).bit_length()
    scratch = levels - PM.LEVEL_POINTS.bit_length()
    assert places == (["scratch"] * scratch + ["shared"] * (levels - 1 -
                                                            scratch)
                      + ["out"])


def test_point_sum_refuses_other_devices():
    _, words = _case("g1", 2, seed=3)
    with pytest.raises(ValueError, match="no point_sum kernel"):
        PM.point_sum(words.to("meta"), "g1")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sum kernel runs only on a card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_matches_plain_on_card(cuda_device, curve):
    """One launch a sum at D >= 2 (none at D = 1, whose entry is the
    sum), equal to the plain version bit for bit at D = 1..16, and at 33
    and 64 (the first level through the scratch), and to the plain
    version run on the card."""
    from infimum_tpu_torch import kernels

    k = kernels.KERNELS[f"point_sum_{curve}"]
    for d in (*range(1, 17), 33, 64):
        _, words = _case(curve, d, seed=11 * d)
        before = k.launches
        got = PM.point_sum(words.to(cuda_device), curve)
        torch.cuda.synchronize()
        assert k.launches == before + (d > 1)
        assert torch.equal(got.cpu(), PM.point_sum_plain(words, curve))
        assert torch.equal(got, PM.point_sum_plain(words.to(cuda_device),
                                                   curve))
