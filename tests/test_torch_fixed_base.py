"""The port's fixed-base multiply (infimum_tpu_torch.msm.fixed_base) against
the JAX package's host windowed fixed-base multiply, and the CUDA kernel's
digit extraction, accumulation and affine epilogue (csrc/fixed_base.cu)
modelled on the CPU against the plain version (`_mul_chunk`, then
`normalize_plain`), bit for bit.

The JAX package's device `fixed_base_mul_batch` is not called: its XLA:CPU
compile takes minutes. Its host path `fixed_base_mul_host` is the ground
truth. The kernel itself runs only on a card (`cuda` marker)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from infimum_tpu.curve.bn254_host import fixed_base_mul_host
from infimum_tpu.ff.bn254 import FQ_MOD, FR_MOD

from infimum_tpu_torch.curve.proj import CURVES
from infimum_tpu_torch.ff.fp import (
    FQ_CTX, ints_to_tensor, limbs_to_words, tensor_to_ints, words_to_limbs,
)
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


def _mul_chunk_words(curve, words: torch.Tensor) -> torch.Tensor:
    """`_mul_chunk`'s projective words, the plain version before its
    normalization."""
    tab = fb._window_table(curve, fb.C, "cpu")
    return limbs_to_words(torch.cat(
        [c.flatten(1) for c in fb._mul_chunk(CURVES[curve], tab,
                                             words_to_limbs(words), fb.C)],
        1))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_accumulation_matches_mul_chunk(curve):
    """The kernel's order (skip zero digits, start from infinity) gives
    `_mul_chunk`'s projective words bit for bit; its epilogue then gives
    the plain version's words and the (n, 2W) layout `mul_words` returns:
    affine standard-form x then y, each c0 then c1 for G2."""
    vals = SCALARS + _high_bit_scalars(6)
    words = ints_to_words(vals, "cpu")
    plain = fb.mul_words(words, CURVES[curve])
    assert plain.dtype == torch.int32
    assert plain.shape == (len(vals), 16 if curve == "g1" else 32)
    proj = _kernel_accumulate(curve, words)
    assert torch.equal(proj, _mul_chunk_words(curve, words))
    assert torch.equal(_kernel_epilogue(curve, proj), plain)
    assert fb.decode_words(plain, CURVES[curve]) == fixed_base_mul_host(
        vals, curve)


def test_plain_chunks_join():
    """The plain version's chunks of CHUNK scalars join in order before
    its one normalization: a chunk of 4 gives the same words as one
    chunk."""
    words = ints_to_words(SCALARS[:11], "cpu")
    whole = fb.mul_words_plain(words, CURVES["g1"])
    chunk = fb.CHUNK
    try:
        fb.CHUNK = 4
        assert torch.equal(fb.mul_words_plain(words, CURVES["g1"]), whole)
    finally:
        fb.CHUNK = chunk
    assert fb.mul_words_plain(words[:0], CURVES["g2"]).shape == (0, 32)


# -- the kernel's epilogue, modelled in python ints ------------------------

R_MONT = (1 << 256) % FQ_MOD          # 1 in Montgomery form
INV32 = -pow(FQ_MOD, -1, 1 << 32) % (1 << 32)   # field.cuh INF_FQ_INV


def _mont(a: int, b: int) -> int:
    return a * b * FQ_CTX.r_inv % FQ_MOD


def _fq2_mont(a, b):
    return ((_mont(a[0], b[0]) - _mont(a[1], b[1])) % FQ_MOD,
            (_mont(a[0], b[1]) + _mont(a[1], b[0])) % FQ_MOD)


def _inv_r_over(a: int, steps: list | None = None) -> int:
    """`inv_r_over` of csrc/fixed_base.cu step by step: Kaliski's almost
    inverse from u = q, v = a, r = 0, s = 1, each pass subtracting the
    smaller odd one of u, v from the larger (and s into r, or r into s)
    and halving the difference to odd at most 31 bits a step (the other
    coefficient doubled as often, k counting the halvings); at u = v = 1,
    s = a^-1 2^k, and a Montgomery product by 2^(512 - k) mod q gives R /
    a. Checks the invariant q = u s + v r, that r and s fit 256 bits and
    that k lies in [253, 506]; `steps` collects each halving's width."""
    u, v, r, s, k = FQ_MOD, a, 0, 1, 0

    def halve(t, x, k):
        while not t & 1:
            low = t & 0xFFFFFFFF
            j = (low & -low).bit_length() - 1 if low else 31
            t, x, k = t >> j, x << j, k + j
            if steps is not None:
                steps.append(j)
        return t, x, k

    v, r, k = halve(v, r, k)
    while u != v:
        assert FQ_MOD == u * s + v * r and r < 1 << 256 and s < 1 << 256
        if u > v:
            u, r = u - v, r + s
            u, s, k = halve(u, s, k)
        else:
            v, s = v - u, s + r
            v, r, k = halve(v, r, k)
    assert u == v == 1 and 253 <= k <= 506
    e = 512 - k
    t = R_MONT * (1 << (e - 256)) % FQ_MOD if e >= 256 else 1 << e
    return _two_chain_mont(s, t)


def _two_chain_mont(a: int, b: int) -> int:
    """field.cuh `two_chains::mul` word by word, with its carries: the
    running sum as an aligned part E (words 0..8) and an offset part O
    (words 1..9), a row's even words' products into E and odd words' into
    O, the reduction by m = E[0] (-q^-1) the same way, the parts re-paired
    after each division by 2^32 with one add whose carry opens the next
    row's O chain; checks every word stays 32 bits and no carry is lost,
    E[0] = 0 after each reduction and the joined sum below 2q."""
    mask = (1 << 32) - 1
    aw = [(a >> (32 * i)) & mask for i in range(8)]
    bw = [(b >> (32 * i)) & mask for i in range(8)]
    pw = [(FQ_MOD >> (32 * i)) & mask for i in range(8)]
    cc = [0]

    def mad(x, y, z, half, carry_in):       # one mad{c}.{lo,hi}.cc
        prod = x * y
        r = (prod & mask if half == "lo" else prod >> 32) + z + (
            cc[0] if carry_in else 0)
        cc[0] = r >> 32
        return r & mask

    def chain(acc, pairs, first, carry_in):
        """acc[first..] += each (x, y)'s low then high half, one chain;
        the carry closes into acc[8] (an addc of 0)."""
        pos = first
        for n, (x, y) in enumerate(pairs):
            for half in ("lo", "hi"):
                acc[pos] = mad(x, y, acc[pos], half, carry_in or pos > first)
                pos += 1
        top = acc[8] + cc[0]
        assert top >> 32 == 0
        acc[8] = top

    def reduce(e, o):
        m = e[0] * INV32 & mask
        chain(o, [(m, pw[j]) for j in (1, 3, 5, 7)], 0, False)
        chain(e, [(m, pw[j]) for j in (0, 2, 4, 6)], 0, False)
        assert e[0] == 0

    e = [0] * 9
    o = [0] * 9
    for j in range(0, 8, 2):
        e[j], e[j + 1] = aw[j] * bw[0] & mask, aw[j] * bw[0] >> 32
        o[j], o[j + 1] = aw[j + 1] * bw[0] & mask, aw[j + 1] * bw[0] >> 32
    reduce(e, o)
    for i in range(1, 8):
        ne, no = o[:], e[2:] + [0, 0]
        ne[0] = o[0] + e[1]
        cc[0], ne[0] = ne[0] >> 32, ne[0] & mask
        chain(no, [(aw[j], bw[i]) for j in (1, 3, 5, 7)], 0, True)
        chain(ne, [(aw[j], bw[i]) for j in (0, 2, 4, 6)], 0, False)
        e, o = ne, no
        reduce(e, o)
    t = sum(w << (32 * i) for i, w in enumerate(e[1:])) + sum(
        w << (32 * i) for i, w in enumerate(o))
    assert t < 2 * FQ_MOD
    return t - FQ_MOD if t >= FQ_MOD else t


def test_two_chain_product_model():
    """The two-chain Montgomery product (field.cuh `two_chains::mul`, the
    fixed-base kernel's) walked word by word gives a b / R mod q, the
    plain version's `FQ_CTX.mont_mul`, at the edges (0, 1, q - 1, R mod q,
    R^2 mod q), for b any power of 2 below 2^256 (the root's last
    product) and at seeded pairs."""
    rng = np.random.default_rng(21)
    edges = [0, 1, 2, FQ_MOD - 1, FQ_MOD - 2, R_MONT, R_MONT * R_MONT %
             FQ_MOD, 1 << 253]
    seeded = [int.from_bytes(rng.bytes(32), "little") % FQ_MOD
              for _ in range(64)]
    pairs = ([(a, b) for a in edges for b in edges]
             + list(zip(seeded[:32], seeded[32:]))
             + [(x, 1 << e) for e, x in enumerate(seeded * 4)])
    got = [_two_chain_mont(a, b) for a, b in pairs]
    assert got == [a * b * FQ_CTX.r_inv % FQ_MOD for a, b in pairs]
    limbs = FQ_CTX.mont_mul(ints_to_tensor([a for a, b in pairs[:96]],
                                           "cpu"),
                            ints_to_tensor([b for a, b in pairs[:96]],
                                           "cpu"))
    assert tensor_to_ints(limbs) == got[:96]


def _kernel_epilogue(curve, proj: torch.Tensor,
                     group: int = fb.GROUP) -> torch.Tensor:
    """The kernel's epilogue on (n, 3W) projective words, block by block of
    `group` lanes in its order: each lane's d (Z, or Z's norm for G2), 1
    where d = 0 or past the end; the tree's levels up (node k = 2k times
    2k + 1), the root through `_inv_r_over`, the levels down (2k gets
    the node's inverse times 2k + 1, and the reverse); then x = X Z^-1,
    y = Y Z^-1 in Montgomery products that leave standard form, (0, 0)
    where d was 0. Returns the (n, 2W) words."""
    g2 = curve == "g2"
    vals = tensor_to_ints(words_to_limbs(proj))
    per = 6 if g2 else 3
    pts = [vals[i:i + per] for i in range(0, len(vals), per)]
    out = []
    for b in range(0, len(pts), group):
        lanes = pts[b:b + group]
        ds = []
        for p in lanes:
            z = p[4:6] if g2 else p[2]
            d = (_mont(z[0], z[0]) + _mont(z[1], z[1])) % FQ_MOD if g2 \
                else z
            ds.append(d)
        tree = [0] * (2 * group)
        for t in range(group):
            d = ds[t] if t < len(ds) else 0
            tree[group + t] = d if d else R_MONT
        s = group // 2
        while s >= 1:
            for t in range(s):
                k = s + t
                tree[k] = _mont(tree[2 * k], tree[2 * k + 1])
            s //= 2
        tree[1] = _inv_r_over(tree[1])
        s = 1
        while s < group:
            for t in range(s):
                k = s + t
                a, c = tree[2 * k], tree[2 * k + 1]
                tree[2 * k], tree[2 * k + 1] = (_mont(tree[k], c),
                                                _mont(tree[k], a))
            s *= 2
        for t, p in enumerate(lanes):
            k = tree[group + t]
            if not ds[t]:
                out += [0] * (4 if g2 else 2)
            elif g2:
                zi = (_mont(p[4], k), -_mont(p[5], k) % FQ_MOD)
                out += [*_fq2_mont(p[0:2], zi), *_fq2_mont(p[2:4], zi)]
            else:
                out += [_mont(p[0], k), _mont(p[1], k)]
    return limbs_to_words(ints_to_tensor(out, "cpu")).reshape(
        len(pts), 32 if g2 else 16)


def test_root_inverse_matches_fermat():
    """`_inv_r_over` (the kernel's root inversion) gives R / a, the
    standard form of Fermat's inverse of the Montgomery word a
    (`FQ_CTX.mont_inv` then `from_mont`), at the edges (1, 2, q - 1, R,
    powers of 2 that halve 31 bits at a time, words with a zero low
    word) and at seeded values."""
    rng = np.random.default_rng(19)
    vals = ([1, 2, 3, FQ_MOD - 1, FQ_MOD - 2, R_MONT, 1 << 31, 1 << 32,
             1 << 200, (1 << 253) + (1 << 64), 5 << 96]
            + [int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
               * int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
               % FQ_MOD for _ in range(40)])
    steps = []
    got = [_inv_r_over(v, steps) for v in vals]
    fermat = tensor_to_ints(FQ_CTX.from_mont(FQ_CTX.mont_inv(
        ints_to_tensor(vals, "cpu"))))
    assert got == fermat == [R_MONT * pow(v, -1, FQ_MOD) % FQ_MOD
                             for v in vals]
    assert max(steps) == 31 and min(steps) == 1


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_epilogue_matches_plain_and_host(curve):
    """The epilogue's model, over blocks of GROUP lanes and of 8 (several
    blocks, a ragged last one), gives `normalize_plain`'s words (one tree
    over all points) on the kernel's projective words, and the JAX
    package's host multiply after decoding."""
    vals = SCALARS + _high_bit_scalars(6)
    words = ints_to_words(vals, "cpu")
    proj = _kernel_accumulate(curve, words)
    plain = fb.normalize_plain(proj, CURVES[curve])
    for group in (fb.GROUP, 8):
        assert torch.equal(_kernel_epilogue(curve, proj, group), plain)
    assert fb.decode_words(plain, CURVES[curve]) == fixed_base_mul_host(
        vals, curve)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_infinity_is_zero_words(curve):
    """Scalars 0, r and 2r (reduced mod r by the wrapper) give the (0, 0)
    words, decoded as None; (0, 0) is on neither curve, so no point is
    taken for infinity."""
    vals = [0, FR_MOD, 2 * FR_MOD, 1]
    got = fb.mul_words(ints_to_words(vals, "cpu"), CURVES[curve])
    assert (got[:3] == 0).all() and (got[3] != 0).any()
    assert fb.decode_words(got, CURVES[curve]) == [None] * 3 + [
        CURVES[curve].gen]
    assert fb.fixed_base_mul_batch(vals, CURVES[curve], device="cpu") == \
        fixed_base_mul_host(vals, curve)
    assert (0 ** 3 + 3) % FQ_MOD != 0          # G1: y^2 = x^3 + 3


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_blocks_of_infinities_and_one_live_point(curve):
    """A block made wholly of infinities (its tree a product of 1s), and a
    block with one live point among infinities, through the kernel's
    model at GROUP and the plain version."""
    g = fb.GROUP
    vals = [0] * g + [0] * 37 + [123456789] + [0] * (g - 38) + [FR_MOD, 9]
    words = ints_to_words(vals, "cpu")
    proj = _kernel_accumulate(curve, words)
    got = _kernel_epilogue(curve, proj)
    assert torch.equal(got, fb.mul_words(words, CURVES[curve]))
    assert (got[:g] == 0).all()
    pts = fb.decode_words(got, CURVES[curve])
    assert pts == fixed_base_mul_host(vals, curve)
    assert [i for i, p in enumerate(pts) if p is not None] == [g + 37,
                                                              2 * g + 1]


def test_window_constants_match_kernel():
    """The kernel's window width and count and its block (the points
    sharing an inversion) are the Python constants, and its table holds
    N_WINDOWS << C rows of 2W words."""
    src = SRC.read_text()
    c = re.search(r"constexpr int kC = (\d+);", src)
    nwin = re.search(r"constexpr int kWindows = (\d+);", src)
    assert (int(c.group(1)), int(nwin.group(1))) == (fb.C, fb.N_WINDOWS)
    group = re.search(r"constexpr int kFixedBlock = (\d+);", src)
    assert int(group.group(1)) == fb.GROUP
    assert fb.GROUP & (fb.GROUP - 1) == 0     # the tree's levels halve
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
    """The kernel's affine words equal the plain version's bit for bit on
    the card, in one launch, over several blocks (one wholly of
    infinities, one with a single live point) and a ragged edge."""
    from infimum_tpu_torch import kernels

    g = fb.GROUP
    head = SCALARS + _high_bit_scalars(64)
    vals = (head + [5] * (3 * g - len(head)) + [0] * g + [7] + [0] * (g - 1)
            + _seeded(18, 3000))
    words = ints_to_words(vals, cuda_device)
    before = kernels.KERNELS[f"fixed_base_{curve}"].launches
    got = fb.mul_words(words, CURVES[curve])
    torch.cuda.synchronize()
    assert kernels.KERNELS[f"fixed_base_{curve}"].launches == before + 1
    assert got.shape == (len(vals), 16 if curve == "g1" else 32)
    assert torch.equal(got, fb.mul_words_plain(words, CURVES[curve]))
    assert (got[3 * g:4 * g] == 0).all() and (got[4 * g] != 0).any()
    assert fb.decode_words(got[:80], CURVES[curve]) == fixed_base_mul_host(
        vals[:80], curve)
    with pytest.raises(ValueError, match="c = 8"):
        fb.mul_words(words, CURVES[curve], c=4)
