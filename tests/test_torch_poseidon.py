"""The port's Poseidon (infimum_tpu_torch.hash.poseidon) and tree builder
(infimum_tpu_torch.parallel.tree) against the JAX package.

Inputs are full-width field elements from numpy seeds, fed to both packages.
On the CPU the port's wrapper runs its plain version, which is held against
the reference's XLA permutation `poseidon_hash_device` (n_inputs 1, 2, 4,
5), its Pallas kernel `poseidon_hash_pallas` in interpret mode (n_inputs 5,
as tests/test_pallas.py runs it), and its host `poseidon_perm_py` at every
width t = 2..13, t = 9 and 13 included. The port's constant tables, in the
plain version's limb form and the kernel's word form, equal the
reference's; its tree builder equals `host_tree_root` and
`sharded_tree_root` on a one-device CPU mesh. The kernel runs only on a
card (`cuda` marker). Tolerance: exact equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from infimum_tpu.ff.fp import FR_CTX as REF_FR
from infimum_tpu.hash.poseidon import _device_params, poseidon_hash_device
from infimum_tpu.hash.poseidon_host import poseidon_perm_py
from infimum_tpu.hash.poseidon_pallas import (
    _params_limb_major, poseidon_hash_pallas,
)
from infimum_tpu.parallel.tree import host_tree_root, sharded_tree_root
from infimum_tpu_torch.ff.bn254 import FR_MOD
from infimum_tpu_torch.ff.fp import FR_CTX, words_to_limbs
from infimum_tpu_torch.hash import poseidon as H
from infimum_tpu_torch.parallel import tree as T

torch.set_num_threads(1)  # the suite runs in parallel worker processes

WIDTHS = range(2, 14)


def _fr(seed, *shape):
    """Full-width elements of Fr from a numpy seed, as nested lists."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(*shape, 8), dtype=np.uint64)
    ints = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
            for row in words.reshape(-1, 8)]
    return np.array(ints, dtype=object).reshape(shape).tolist()


def _enc(cols):
    """Columns of ints -> (n, B, 16) uint32 Montgomery limbs (numpy)."""
    return np.stack([REF_FR.encode(c) for c in cols])


def _port(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int64))


@pytest.mark.parametrize("n_inputs", [1, 2, 4, 5])
def test_hash_matches_xla_device(n_inputs):
    enc = _enc(_fr(n_inputs, n_inputs, 8))
    want = np.asarray(poseidon_hash_device(jnp.asarray(enc)))
    got = H.poseidon_hash(_port(enc))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_hash_matches_pallas_interpret():
    enc = _enc(_fr(55, 5, 8))
    want = np.asarray(poseidon_hash_pallas(jnp.asarray(enc)))
    got = H.poseidon_hash(_port(enc))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("t", WIDTHS)
def test_perm_matches_host(t):
    states = _fr(100 + t, 3, t)
    states[0] = [0] * t                      # the all-zero state
    states[1][0] = FR_MOD - 1                # p - 1 in the first lane
    enc = _port(_enc([list(c) for c in zip(*states)]))
    out = H.poseidon_perm(enc)
    got = [FR_CTX.decode(out[:, b]) for b in range(len(states))]
    assert got == [poseidon_perm_py(s) for s in states]


@pytest.mark.parametrize("t", WIDTHS)
def test_tables_match_reference(t):
    ark, mds, full = H.device_params(t)
    ref_ark, ref_mds, ref_full = _device_params(t)
    assert np.array_equal(ark, ref_ark) and np.array_equal(mds, ref_mds)
    assert np.array_equal(full, ref_full)
    lm_ark, lm_mds, lm_full = _params_limb_major(t)
    assert np.array_equal(full, lm_full.reshape(-1))
    limb_ark, limb_mds = H.tables(t, "cpu", words=False)
    word_ark, word_mds = H.tables(t, "cpu", words=True)
    assert word_ark.dtype == torch.int32 and word_ark.shape[-1] == 8
    for limbs, words, want in ((limb_ark, word_ark, lm_ark[..., 0]),
                               (limb_mds, word_mds, lm_mds[..., 0])):
        assert np.array_equal(limbs.numpy(), want.astype(np.int64))
        assert np.array_equal(words_to_limbs(words).numpy(),
                              want.astype(np.int64))


def test_batch_matches_host_hash():
    cols = _fr(7, 3, 5)
    got = H.poseidon_batch(cols, device="cpu")
    assert got == [poseidon_perm_py([0] + list(r))[0] for r in zip(*cols)]


def test_wrapper_refuses_other_devices():
    state = torch.zeros((3, 2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        H.poseidon_perm(state)
    with pytest.raises(ValueError):
        H.perm_words(torch.zeros((3, 8, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        H.poseidon_perm(torch.zeros((14, 2, 16), dtype=torch.int64))


@pytest.mark.parametrize("arity,depth", [(2, 4), (5, 2)])
def test_tree_matches_reference(arity, depth):
    leaves = _fr(arity * 10 + depth, arity ** depth - 3)
    level = H.merkle_level(FR_CTX.encode(leaves[:2 * arity], "cpu"), arity)
    assert FR_CTX.decode(level) == [
        poseidon_perm_py([0] + leaves[i:i + arity])[0]
        for i in (0, arity)]
    got = T.tree_root(arity, depth, leaves, device="cpu")
    assert got == host_tree_root(arity, depth, leaves)
    assert got == T.host_tree_root(arity, depth, leaves)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    assert got == sharded_tree_root(mesh, "dp", arity, depth, leaves)
    with pytest.raises(ValueError):
        T.build_tree(FR_CTX.encode(leaves, "cpu"), arity, depth)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Poseidon kernel runs only on "
                    "a card")
    return "cuda"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The kernel against its plain version on the same card tensors, at
    every width and a batch that is not a multiple of the block."""
    for t in WIDTHS:
        state = _port(_enc(_fr(200 + t, t, 1000))).to(cuda_device)
        assert torch.equal(H.poseidon_perm(state),
                           H.poseidon_perm_plain(state)), t
