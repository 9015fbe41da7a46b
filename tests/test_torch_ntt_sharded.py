"""The sharded NTT's words path (infimum_tpu_torch.parallel.ntt: the slab
kept in 32-bit words from the first local transform to the second, the
twiddle product through `ntt.pointwise`) against the limbs path it
replaced, on one rank with no process group (world 1, no spawn).

The limbs path is written out here as it ran: `ntt` on limbs over each
axis and the twiddle product by `FR_CTX.mont_mul` on the slab's limbs.
Each rank's slab must equal it limb for limb. The groups of 2, 4 and 8
ranks are held against the JAX package in tests/test_torch_parallel.py."""

import random

import pytest
import torch

from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.ntt.ntt import ntt_host

from infimum_tpu_torch.ff.fp import (
    FR_CTX, NLIMBS, device_key, limbs_to_words, words_to_limbs,
)
from infimum_tpu_torch.ntt.ntt import ntt
from infimum_tpu_torch.parallel import distributed as D
from infimum_tpu_torch.parallel import ntt as PN

torch.set_num_threads(1)  # the suite runs in parallel worker processes

MESH = D.ProvingMesh(0, 1, torch.device("cpu"))


def _old_slab(logn2, logn1, invert, device="cpu"):
    return PN._twiddle_slab(logn2, logn1, invert, 0, 1 << logn1, device)


def _old_forward(a_l, logn2, logn1, invert):
    """The limbs path of the forward four-step transform at world 1."""
    tw = _old_slab(logn2, logn1, invert)
    c = FR_CTX.mont_mul(ntt(a_l.transpose(0, 1), logn2, invert)
                        .transpose(0, 1), tw)
    got = limbs_to_words(c)                  # the all_to_all of one rank
    x = got.reshape(1, 1 << logn2, a_l.shape[1], NLIMBS // 2) \
           .transpose(0, 1).reshape(1 << logn2, -1, NLIMBS // 2)
    return ntt(words_to_limbs(x), logn1, invert)


def _old_inverse(d_l, logn2, logn1):
    tw_inv = _old_slab(logn2, logn1, True)
    x = limbs_to_words(ntt(d_l, logn1, True))
    n2l, n1 = d_l.shape[:2]
    blocks = x.reshape(n2l, 1, n1, NLIMBS // 2).transpose(0, 1) \
              .reshape(-1, n1, NLIMBS // 2)
    c = FR_CTX.mont_mul(words_to_limbs(blocks), tw_inv)
    return ntt(c.transpose(0, 1), logn2, True).transpose(0, 1)


def _values(logn, seed):
    rng = random.Random(seed)
    return [rng.randrange(FR_MOD) for _ in range(1 << logn)]


@pytest.mark.parametrize("logn", (4, 7, 8))
@pytest.mark.parametrize("invert", (False, True))
def test_words_path_matches_limbs_path(logn, invert):
    """Forward (and its inverse-root twin) on one rank: the words path's
    k-form slab equals the limbs path's limb for limb."""
    fn, logn2, logn1 = PN.make_ntt_sharded(MESH, logn, invert)
    vals = _values(logn, 30 + logn + invert)
    a_l = PN.column_slab(vals, MESH, logn2, logn1)
    got = fn(a_l)
    assert got.dtype == torch.int64 and got.shape == (1 << logn2,
                                                      1 << logn1, NLIMBS)
    assert torch.equal(got, _old_forward(a_l, logn2, logn1, invert))
    if not invert:      # out[k2, k1] = NTT(a)[k1 N2 + k2]
        want = ntt_host(vals)
        kform = FR_CTX.decode(got.transpose(0, 1))
        assert kform == want


@pytest.mark.parametrize("logn", (4, 7, 8))
def test_inverse_words_path_matches_limbs_path(logn):
    """The inverse on one rank equals the limbs path limb for limb and
    undoes the forward exactly."""
    fwd, logn2, logn1 = PN.make_ntt_sharded(MESH, logn)
    inv = PN.make_intt_sharded(MESH, logn)
    a_l = PN.column_slab(_values(logn, 50 + logn), MESH, logn2, logn1)
    d_l = fwd(a_l)
    back = inv(d_l)
    assert torch.equal(back, _old_inverse(d_l, logn2, logn1))
    assert torch.equal(back, a_l)


def test_twiddle_words_are_the_slab():
    """The cached twiddle words are the limb slab, transposed to the
    layout the axis-0 transform leaves: [j1, k2]."""
    logn2, logn1 = 4, 3
    dev = device_key("cpu")
    tw = PN._twiddle_words(logn2, logn1, False, 2, 4, dev)
    slab = PN._twiddle_slab(logn2, logn1, False, 2, 4, dev)
    assert tw.dtype == torch.int32 and tw.is_contiguous()
    assert tw.shape == (4, 1 << logn2, NLIMBS // 2)
    assert torch.equal(words_to_limbs(tw), slab.transpose(0, 1))
