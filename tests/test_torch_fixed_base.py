"""The port's fixed-base multiply (infimum_tpu_torch.msm.fixed_base) against
the JAX package's host windowed fixed-base multiply, and the CUDA kernel's
digit extraction and accumulation (csrc/fixed_base.cu) modelled on the CPU
against the plain version `_mul_chunk`, bit for bit.

The JAX package's device `fixed_base_mul_batch` is not called: its XLA:CPU
compile takes minutes. Its host path `fixed_base_mul_host` is the ground
truth. The kernel itself runs only on a card (`cuda` marker)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from infimum_tpu.curve.bn254_host import fixed_base_mul_host
from infimum_tpu.ff.bn254 import FR_MOD

from infimum_tpu_torch.curve.proj import CURVES
from infimum_tpu_torch.ff.fp import ints_to_tensor, limbs_to_words
from infimum_tpu_torch.groth16.rowval import ints_to_words
from infimum_tpu_torch.msm import fixed_base as fb

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SRC = (pathlib.Path(fb.__file__).parents[1] / "csrc" / "fixed_base.cu")


def _seeded(seed, n):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
            for row in words]


# scalars at the edges: 0, 1, 2, r - 1, r + 5 (reduces to 5); ones with
# zero windows (single windows 2^(8k), sums of a few); 48 from a seed
EDGES = [0, 1, 2, FR_MOD - 1, FR_MOD + 5]
ZERO_WINDOWS = ([1 << (8 * k) for k in (1, 2, 7, 15, 16, 31)]
                + [(1 << 8) + (1 << 64) + (1 << 200),
                   (3 << 24) + (255 << 128), (1 << 248) + 1])
SCALARS = EDGES + ZERO_WINDOWS + _seeded(16, 48)


def _high_bit_scalars(n, seed=17):
    """Scalars below r whose 32-bit words 0..6 all have bit 31 set: the
    words are negative as torch's int32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        low = sum((int(rng.integers(0, 1 << 31)) | 1 << 31) << (32 * i)
                  for i in range(7))
        out.append(low + (int(rng.integers(0, 0x30644E72)) << 224))
    return out


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_fixed_base_matches_host(curve):
    """fixed_base_mul_batch on the CPU equals the JAX package's host
    windowed multiply point for point (None for 0 and r)."""
    got = fb.fixed_base_mul_batch(SCALARS, CURVES[curve], device="cpu")
    assert got == fixed_base_mul_host(SCALARS, curve)
    assert got[0] is None and got[1] == CURVES[curve].gen
    cdev = CURVES[curve]
    assert got[EDGES.index(FR_MOD + 5)] == cdev.host_mul(cdev.gen, 5)


def test_scalar_words_reduce_mod_r():
    """The words the multiply reads (`ints_to_words`) are the standard-form
    limbs' words of s mod r, including r + 5 -> 5, r - 1, and words with
    bit 31 set."""
    vals = SCALARS + _high_bit_scalars(8)
    got = ints_to_words(vals, "cpu")
    want = limbs_to_words(ints_to_tensor([v % FR_MOD for v in vals], "cpu"))
    assert got.dtype == torch.int32 and got.shape == (len(vals), 8)
    assert torch.equal(got, want)
    assert int(got[EDGES.index(FR_MOD + 5), 0]) == 5
    assert (got[len(SCALARS):, :7] < 0).all()     # bit 31 set: negative
    assert ints_to_words([], "cpu").shape == (0, 8)


def _kernel_digits(words: torch.Tensor) -> np.ndarray:
    """The kernel's digit extraction, modelled in numpy: the (n, 8) int32
    words read as uint32; each window takes the low byte of word 0, then
    the 256-bit value shifts right by 8 (funnel shifts word by word)."""
    s = words.numpy().view(np.uint32).astype(np.uint64)
    digits = np.zeros((s.shape[0], fb.N_WINDOWS), dtype=np.int64)
    for w in range(fb.N_WINDOWS):
        digits[:, w] = s[:, 0] & ((1 << fb.C) - 1)
        for k in range(7):   # __funnelshift_r(s[k], s[k + 1], 8)
            s[:, k] = ((s[:, k] >> fb.C) | (s[:, k + 1] << (32 - fb.C))) \
                & 0xFFFFFFFF
        s[:, 7] >>= fb.C
    return digits


def _mul_chunk_digits(limbs: torch.Tensor) -> np.ndarray:
    """The digits `_mul_chunk` takes from (n, 16) standard-form limbs."""
    per_limb = 16 // fb.C
    return np.stack([((limbs[:, w // per_limb] >> ((w % per_limb) * fb.C))
                      & ((1 << fb.C) - 1)).numpy()
                     for w in range(fb.N_WINDOWS)], 1)


def test_kernel_digits_match_mul_chunk():
    """Digits from int32 words (bit 31 set in most) equal `_mul_chunk`'s
    from the limbs of the same scalars."""
    vals = SCALARS + _high_bit_scalars(64)
    words = ints_to_words(vals, "cpu")
    limbs = ints_to_tensor([v % FR_MOD for v in vals], "cpu")
    got = _kernel_digits(words)
    assert np.array_equal(got, _mul_chunk_digits(limbs))
    # every scalar is its digits
    assert [sum(int(d) << (8 * w) for w, d in enumerate(row))
            for row in got] == [v % FR_MOD for v in vals]


def _kernel_accumulate(curve, words: torch.Tensor) -> torch.Tensor:
    """The kernel's accumulation, modelled with the port's torch curve:
    from infinity, windows in ascending order, the mixed add of the
    window's table point only where the digit is not 0 (no select)."""
    cdev = CURVES[curve]
    tab = fb._window_table(curve, fb.C, "cpu")
    digits = torch.from_numpy(_kernel_digits(words))
    acc = [c.clone() for c in cdev.infinity((words.shape[0],), "cpu")]
    for w in range(fb.N_WINDOWS):
        live = (digits[:, w] != 0).nonzero()[:, 0]
        if live.numel() == 0:
            continue
        pt = tab[(w << fb.C) + digits[live, w]]
        out = cdev.add_mixed(tuple(c[live] for c in acc),
                             (pt[:, 0], pt[:, 1]))
        for c, o in zip(acc, out):
            c[live] = o
    return limbs_to_words(torch.cat([c.flatten(1) for c in acc], 1))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_accumulation_matches_mul_chunk(curve):
    """The kernel's order (skip zero digits, start from infinity) gives
    `_mul_chunk`'s projective words bit for bit, and the (n, 3W) layout
    `mul_words` returns: X, Y, Z, each c0 then c1 for G2."""
    vals = SCALARS + _high_bit_scalars(6)
    words = ints_to_words(vals, "cpu")
    plain = fb.mul_words(words, CURVES[curve])
    assert plain.dtype == torch.int32
    assert plain.shape == (len(vals), 24 if curve == "g1" else 48)
    assert torch.equal(_kernel_accumulate(curve, words), plain)
    assert fb.decode_words(plain, CURVES[curve]) == fixed_base_mul_host(
        vals, curve)


def test_plain_chunks_join():
    """The plain version's chunks of CHUNK scalars join in order: a chunk
    of 4 gives the same words as one chunk."""
    words = ints_to_words(SCALARS[:11], "cpu")
    whole = fb.mul_words_plain(words, CURVES["g1"])
    chunk = fb.CHUNK
    try:
        fb.CHUNK = 4
        assert torch.equal(fb.mul_words_plain(words, CURVES["g1"]), whole)
    finally:
        fb.CHUNK = chunk
    assert fb.mul_words_plain(words[:0], CURVES["g2"]).shape == (0, 48)


def test_window_constants_match_kernel():
    """The kernel's window width and count are the Python constants, and
    its table holds N_WINDOWS << C rows of 2W words."""
    src = SRC.read_text()
    c = re.search(r"constexpr int kC = (\d+);", src)
    nwin = re.search(r"constexpr int kWindows = (\d+);", src)
    assert (int(c.group(1)), int(nwin.group(1))) == (fb.C, fb.N_WINDOWS)
    assert fb.N_WINDOWS * fb.C == 256
    for curve, aw in (("g1", 16), ("g2", 32)):
        assert fb.table_words(curve, "cpu").shape == (fb.N_WINDOWS << fb.C,
                                                      aw)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches or raises: another c, or another
    device, is refused before any launch."""
    words = ints_to_words([1, 2], "cpu")
    with pytest.raises(ValueError, match="no fixed_base kernel"):
        fb.mul_words(words.to("meta"), CURVES["g1"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fixed-base kernel runs only on "
                    "a card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_matches_plain_on_card(cuda_device, curve):
    """The kernel's words equal the plain version's bit for bit on the
    card, in one launch, over several blocks and a ragged edge."""
    from infimum_tpu_torch import kernels

    vals = SCALARS + _high_bit_scalars(64) + _seeded(18, 3000)
    words = ints_to_words(vals, cuda_device)
    before = kernels.KERNELS[f"fixed_base_{curve}"].launches
    got = fb.mul_words(words, CURVES[curve])
    torch.cuda.synchronize()
    assert kernels.KERNELS[f"fixed_base_{curve}"].launches == before + 1
    assert torch.equal(got, fb.mul_words_plain(words, CURVES[curve]))
    assert fb.decode_words(got[:80], CURVES[curve]) == fixed_base_mul_host(
        vals[:80], curve)
    with pytest.raises(ValueError, match="c = 8"):
        fb.mul_words(words, CURVES[curve], c=4)
