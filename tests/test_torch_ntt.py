"""Port NTT (infimum_tpu_torch.ntt) against the reference ntt_device /
coset_ntt_device (JAX on the CPU) and the host ntt_host, on the same
Montgomery limbs from a numpy seed; results must be equal limb for limb."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.ff.fp import FR_CTX as REF_FR
from infimum_tpu.ntt import (
    coset_intt_device, coset_ntt_device, intt_host, ntt_device, ntt_host,
)
from infimum_tpu_torch.ff.fp import FR_CTX, to_tensor
from infimum_tpu_torch.ntt.ntt import coset_intt, coset_ntt, intt, ntt

torch.set_num_threads(1)  # the suite runs in parallel worker processes

COSET_GEN = 5


def _coeffs(seed, n):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    out = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
           for row in words]
    out[0] = FR_MOD - 1
    return out


@pytest.mark.parametrize("logn", [1, 4, 10])
def test_ntt_matches_reference(logn):
    coeffs = _coeffs(logn, 1 << logn)
    enc = REF_FR.encode(coeffs)
    got = ntt(to_tensor(enc, "cpu"), logn)
    want = np.asarray(ntt_device(jnp.asarray(enc), logn))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert FR_CTX.decode(got) == ntt_host(coeffs)
    back = intt(got, logn)
    assert torch.equal(back, to_tensor(enc, "cpu"))
    assert FR_CTX.decode(intt(to_tensor(enc, "cpu"), logn)) == intt_host(coeffs)


@pytest.mark.parametrize("logn", [2, 8])
def test_coset_ntt_matches_reference(logn):
    coeffs = _coeffs(100 + logn, 1 << logn)
    enc = REF_FR.encode(coeffs)
    got = coset_ntt(to_tensor(enc, "cpu"), logn, COSET_GEN)
    want = np.asarray(coset_ntt_device(jnp.asarray(enc), logn, COSET_GEN))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    shifted = [c * pow(COSET_GEN, i, FR_MOD) % FR_MOD
               for i, c in enumerate(coeffs)]
    assert FR_CTX.decode(got) == ntt_host(shifted)
    back = coset_intt(got, logn, COSET_GEN)
    assert torch.equal(back, to_tensor(enc, "cpu"))
    ref_back = np.asarray(coset_intt_device(jnp.asarray(want), logn,
                                            COSET_GEN))
    assert np.array_equal(back.numpy(), ref_back.astype(np.int64))


def test_batched_transforms_match_single():
    """Leading dims batch several transforms through each stage."""
    logn = 6
    rows = [to_tensor(REF_FR.encode(_coeffs(s, 1 << logn)), "cpu")
            for s in (1, 2, 3)]
    batched = coset_ntt(intt(torch.stack(rows), logn), logn, COSET_GEN)
    for i, r in enumerate(rows):
        assert torch.equal(batched[i],
                           coset_ntt(intt(r, logn), logn, COSET_GEN))
