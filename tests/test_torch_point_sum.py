"""The sharded MSM's cross-rank sum (infimum_tpu_torch.parallel.msm
`point_sum`, csrc/point_sum.cu) against the JAX package's
`_tree_reduce_axis0` and host affine sums, on the CPU, with no process
group.

D = 1, 2, 3, 4, 5 and 8 projective points a window, G1 and G2, each a
random projective scaling of an affine point, with windows of infinity
entries (two forms of it), a point plus itself and a point plus its
negation. The kernel's walk over the halving levels is modelled with the
port's torch curve and held against the plain version bit for bit. The
kernel itself runs only on a card (`cuda` marker)."""

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
DS = (1, 2, 3, 4, 5, 8)


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


def _kernel_walk(curve, words):
    """The kernel's walk, modelled with the port's torch curve: half = T/2;
    the first level adds input i and i + half (infinity at or above D)
    into the scratch (the output when half is 1), then each level adds
    scratch i and i + half in place. At D = 1 the wrapper launches
    nothing and returns the entry."""
    spec = SPECS[curve]
    cdev = spec.curve
    d, nwin = words.shape[:2]
    limbs = words_to_limbs(words).unflatten(-1, (3, *cdev.fshape()))
    entry = [tuple(limbs[i, :, k] for k in range(3)) for i in range(d)]
    if d == 1:
        out = entry[0]
    else:
        half = 1
        while 2 * half < d:
            half *= 2
        inf = cdev.infinity((nwin,), "cpu")
        scratch = [cdev.add(entry[i], entry[i + half] if i + half < d
                            else inf) for i in range(half)]
        while half > 1:
            half //= 2
            for i in range(half):
                scratch[i] = cdev.add(scratch[i], scratch[i + half])
        out = scratch[0]
    return limbs_to_words(torch.cat([c.flatten(1) for c in out], 1))


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
    assert torch.equal(_kernel_walk(curve, words), got)
    if d == 2:
        cdev = SPECS[curve].curve
        limbs = words_to_limbs(words).unflatten(-1, (3, *cdev.fshape()))
        pair = cdev.add(*(tuple(limbs[i, :, k] for k in range(3))
                          for i in range(2)))
        assert torch.equal(got, limbs_to_words(
            torch.cat([c.flatten(1) for c in pair], 1)))


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
    sum), equal to the plain version bit for bit at every D, and to the
    plain version run on the card."""
    from infimum_tpu_torch import kernels

    k = kernels.KERNELS[f"point_sum_{curve}"]
    for d in DS + (7, 16):
        _, words = _case(curve, d, seed=11 * d)
        before = k.launches
        got = PM.point_sum(words.to(cuda_device), curve)
        torch.cuda.synchronize()
        assert k.launches == before + (d > 1)
        assert torch.equal(got.cpu(), PM.point_sum_plain(words, curve))
        assert torch.equal(got, PM.point_sum_plain(words.to(cuda_device),
                                                   curve))
