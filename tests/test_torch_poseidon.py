"""The port's Poseidon (infimum_tpu_torch.hash.poseidon) and tree builder
(infimum_tpu_torch.parallel.tree) against the JAX package.

Inputs are full-width field elements from numpy seeds, fed to both packages.
On the CPU the port's wrapper runs its plain version, the optimized form
(folded constants, sparse partial rounds, `hash/poseidon_sparse.py`),
which is held against the reference's XLA permutation
`poseidon_hash_device` (n_inputs 1, 2, 4, 5), its Pallas kernel
`poseidon_hash_pallas` in interpret mode (n_inputs 5, as tests/test_pallas.py
runs it), its host `poseidon_perm_py` at every width t = 2..13, t = 9 and
13 included, the port's plain dense form, and circomlibjs's poseidon([1]).
The dense tables equal the reference's; the optimized tables have the
optimized form's sizes, and their limb form (the plain version's) and word
form (the kernel's) agree. The tree builder equals `host_tree_root` and
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
from infimum_tpu_torch.hash.grain import (
    FULL_ROUNDS, PARTIAL_ROUNDS, poseidon_params,
)
from infimum_tpu_torch.hash.poseidon_sparse import sparse_params
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
    """The dense tables equal the reference's; the optimized form keeps the
    MDS matrix and the first round's constants, in limbs and in words."""
    ark, mds, full = H.device_params(t)
    ref_ark, ref_mds, ref_full = _device_params(t)
    assert np.array_equal(ark, ref_ark) and np.array_equal(mds, ref_mds)
    assert np.array_equal(full, ref_full)
    lm_ark, lm_mds, lm_full = _params_limb_major(t)
    assert np.array_equal(full, lm_full.reshape(-1))
    limb_ark, limb_mds = H.dense_tables(t, "cpu")
    for limbs, want in ((limb_ark, lm_ark[..., 0]),
                        (limb_mds, lm_mds[..., 0])):
        assert np.array_equal(limbs.numpy(), want.astype(np.int64))
    limb_c, limb_m, _, _ = H.tables(t, "cpu", words=False)
    word_c, word_m, _, _ = H.tables(t, "cpu", words=True)
    assert word_c.dtype == torch.int32 and word_c.shape[-1] == 8
    want_mds = lm_mds[..., 0].astype(np.int64)
    assert np.array_equal(limb_m.numpy(), want_mds)
    assert np.array_equal(words_to_limbs(word_m).numpy(), want_mds)
    want_c0 = lm_ark[0, ..., 0].astype(np.int64)
    assert np.array_equal(limb_c[:t].numpy(), want_c0)
    assert np.array_equal(words_to_limbs(word_c[:t]).numpy(), want_c0)


@pytest.mark.parametrize("t", WIDTHS)
def test_sparse_matches_dense_and_host(t):
    """The optimized plain version against the dense one and the
    reference's host permutation, limb for limb."""
    states = _fr(300 + t, 4, t)
    states[0] = [0] * t
    states[1] = [FR_MOD - 1] * t
    enc = _port(_enc([list(c) for c in zip(*states)]))
    sparse = H.poseidon_perm_plain(enc)
    assert torch.equal(sparse, H.poseidon_perm_dense_plain(enc))
    want = [poseidon_perm_py(s) for s in states]
    assert np.array_equal(sparse.numpy(), np.stack(
        [REF_FR.encode(c) for c in zip(*want)]).astype(np.int64))


@pytest.mark.parametrize("n_inputs", [1, 2, 4, 5])
def test_sparse_hash_matches_xla_device(n_inputs):
    enc = _port(_enc(_fr(40 + n_inputs, n_inputs, 6)))
    want = np.asarray(poseidon_hash_device(jnp.asarray(enc.numpy().astype(
        np.uint32)))).astype(np.int64)
    state = torch.cat([torch.zeros_like(enc[:1]), enc])
    assert np.array_equal(H.poseidon_perm_plain(state)[0].numpy(), want)
    assert np.array_equal(H.poseidon_perm_dense_plain(state)[0].numpy(),
                          want)


# circomlibjs poseidon([1])
POSEIDON_1 = int("1858613376851222093662057074591294061967785426927468947558"
                 "5506675881198879027")


def test_circomlibjs_vector():
    assert H.poseidon_batch([[1]], device="cpu") == [POSEIDON_1]


@pytest.mark.parametrize("t", WIDTHS)
def test_sparse_table_sizes(t):
    """C holds t R_F + R_P constants; each of the R_P partial rounds has a
    first row and a first column, 2t - 1 entries, whose first entry is
    M[0][0]; P keeps M's first row. M is not symmetric, so the equality
    tests above tell s <- M s from s <- M^T s."""
    r_p = PARTIAL_ROUNDS[t - 2]
    sp = sparse_params(t)
    mds = poseidon_params(t)[1]
    assert len(sp.c) == t * FULL_ROUNDS + r_p
    assert len(sp.s) == r_p and all(len(row) == 2 * t - 1 for row in sp.s)
    assert all(row[0] == mds[0][0] for row in sp.s)
    assert sp.m == mds and sp.p[0] == mds[0]
    assert len(sp.p) == t and all(len(row) == t for row in sp.p)
    assert mds != [list(col) for col in zip(*mds)]
    c, m, p, s = H.tables(t, "cpu", words=False)
    assert c.shape == (t * FULL_ROUNDS + r_p, 16)
    assert m.shape == p.shape == (t, t, 16)
    assert s.shape == (r_p, 2 * t - 1, 16)


@pytest.mark.parametrize("t", WIDTHS)
def test_table_forms_agree(t):
    """Every optimized table: the kernel's int32 words equal the plain
    version's int64 limbs, which decode to `sparse_params`' ints."""
    sp = sparse_params(t)
    limbs = H.tables(t, "cpu", words=False)
    words = H.tables(t, "cpu", words=True)
    for lim, wor, want in zip(limbs, words, (sp.c, sp.m, sp.p, sp.s)):
        assert wor.dtype == torch.int32 and wor.is_contiguous()
        assert wor.shape == (*lim.shape[:-1], 8)
        assert torch.equal(words_to_limbs(wor), lim)
        flat = np.asarray(want, dtype=object).reshape(-1).tolist()
        assert FR_CTX.decode(lim) == flat


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
@pytest.mark.parametrize("b", [1000, 1, 129])
def test_kernel_matches_plain_on_card(cuda_device, b):
    """The kernel against its plain version on the same card tensors, at
    every width, at batches that are not a multiple of the block (one
    state; one past a block)."""
    for t in WIDTHS:
        state = _port(_enc(_fr(200 + t + b, t, b))).to(cuda_device)
        assert torch.equal(H.poseidon_perm(state),
                           H.poseidon_perm_plain(state)), t


@pytest.mark.cuda
def test_kernel_variants_match_on_card(cuda_device):
    """Each measured variant of the kernel at t = 6 (product inlined or out
    of line, tables through __ldg or in shared memory) equals the main
    instance."""
    from infimum_tpu_torch.ff.fp import limbs_to_words

    state = _port(_enc(_fr(77, 6, 300))).to(cuda_device)
    words = limbs_to_words(state).transpose(1, 2).contiguous()
    want = H.perm_words(words)
    for name, variant in H.VARIANTS.items():
        assert torch.equal(H.perm_words(words, variant), want), name
