"""Radix-2 NTT / iNTT / coset NTT over BN254 Fr, and the elementwise Fr
step of the H pipeline: CUDA kernels on a card, plain PyTorch elsewhere.

Counterpart of `infimum_tpu/ntt/ntt.py:80-229`: iterative Cooley-Tukey
(decimation in time), a bit-reversal gather, then log2(n) butterfly
stages with the same packed twiddle table; leading dims batch several
transforms through every stage together.

Two layers:
  - words (`ntt_words`, `pointwise`): (..., n, 8) int32 words of
    Montgomery values, the layout of `csrc/fr_ntt.cu`. On a CUDA tensor
    `ntt_words` is one tile launch (the bit-reversal gather, by gather
    mode of one input, of a.b - c from three inputs (PRODUCT) or of a, b
    and a.b from two (AB), an optional input table, stages 1..TILE_LOG)
    and one pass launch for each range of `pass_plan(logn)` (up to
    PASS_LOG stages each: one pass for 2^12-2^18), the output multiplies
    fused into the last launch; `pointwise` is one launch. On a CPU
    tensor each launch is replaced by its plain version
    (`ntt_tile_plain`, `ntt_pass_plain`, `pointwise_plain`), which
    compute the same values with `ff/fp.py`'s limb arithmetic; any other
    device is refused.
  - limbs (`ntt`, `intt`, `coset_ntt`, `coset_intt`): (..., n, 16) int64
    Montgomery limbs, the signature `parallel/ntt.py` and the tests use.
    On every device they convert to words and back around `ntt_words`.
    `ntt_plain`, `coset_ntt_plain` and `coset_intt_plain` are the plain
    transform in limbs (each stage one batched `mont_mul` plus an add and
    a sub over the whole array): the reference for the H stage's plain
    version and the tests.

Tables are built on the host once per size and kept per device
(`device_key`): the plain limb tables, and for the kernels the same
values as words (`word_tables`, `coset_words`, `fr_const`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..ff.bn254 import (
    FR_MOD, FR_TWO_ADIC_ROOT, FR_TWO_ADICITY, fr_inv,
)
from ..ff.fp import (
    FR_CTX, NLIMBS, device_key, int_limbs, limbs_to_words, words_to_limbs,
)

TILE_LOG = 11   # csrc/fr_ntt.cu kTileLog: stages of the tile launch
PASS_LOG = 7    # csrc/fr_ntt.cu kPassLog: the most stages of a pass launch
# the tile launch's gather modes (csrc/fr_ntt.cu kGather*): one input a
# transform; a.b - c of three; a, b and a.b from two (three out)
VALUE, PRODUCT, AB = 0, 1, 2
WORDS = NLIMBS // 2


def _root_of_unity(n: int) -> int:
    """Primitive n-th root of unity in Fr (n a power of two <= 2^28)."""
    logn = n.bit_length() - 1
    assert 1 << logn == n and logn <= FR_TWO_ADICITY
    w = FR_TWO_ADIC_ROOT
    for _ in range(FR_TWO_ADICITY - logn):
        w = w * w % FR_MOD
    return w


def _powers(x: int, n: int) -> list[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * x % FR_MOD
    return out


def _bitrev(logn: int) -> np.ndarray:
    n = 1 << logn
    rev = np.zeros(n, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_consts(logn: int, invert: bool, device: str):
    """(bit-reversal permutation, packed twiddles, 1/n in Montgomery form).

    Stage s (half = 2^(s-1)) uses rows [half-1, 2*half-1) of the packed
    (n-1, 16) twiddle table: w_len^k for k < half, w_len = w^(n / 2^s)."""
    n = 1 << logn
    w = _root_of_unity(n)
    if invert:
        w = fr_inv(w)
    flat = []
    for s in range(1, logn + 1):
        flat += _powers(pow(w, n >> s, FR_MOD), 1 << (s - 1))
    tw = FR_CTX.encode(flat, device) if flat else torch.zeros(
        (0, NLIMBS), dtype=torch.int64, device=device)
    n_inv = FR_CTX.encode([fr_inv(n)], device)[0]
    return torch.from_numpy(_bitrev(logn)).to(device), tw, n_inv


@functools.lru_cache(maxsize=None)
def _coset_consts(logn: int, g: int, invert: bool, device: str):
    """(n, 16) Montgomery powers g^i, or (g^-1)^i when `invert`."""
    return FR_CTX.encode(_powers(fr_inv(g) if invert else g, 1 << logn),
                         device)


@functools.lru_cache(maxsize=None)
def word_tables(logn: int, invert: bool, device: str):
    """(packed twiddles (n-1, 8), 1/n (8,)) as the kernels read them: the
    words of `_stage_consts`' limbs, built on the host, kept on `device`
    (8 MB at 2^18)."""
    _, tw, n_inv = _stage_consts(logn, invert, "cpu")
    return limbs_to_words(tw).to(device), limbs_to_words(n_inv).to(device)


@functools.lru_cache(maxsize=None)
def coset_words(logn: int, g: int, invert: bool, device: str):
    """The words of `_coset_consts`' limbs, kept on `device`."""
    return limbs_to_words(_coset_consts(logn, g, invert, "cpu")).to(device)


@functools.lru_cache(maxsize=None)
def fr_const(x: int, device: str, mont: bool = True) -> torch.Tensor:
    """(8,) words of x mod r: in Montgomery form, or as it stands with
    `mont=False` (a Montgomery product by such a constant leaves
    Montgomery form: mont_mul(aR, c) = a c)."""
    x %= FR_MOD
    v = FR_CTX.to_mont_int(x) if mont else x
    return limbs_to_words(torch.tensor(int_limbs(v))).to(device)


def _words_check(name: str, x: torch.Tensor, shape=None) -> None:
    if x.dtype != torch.int32 or not x.is_contiguous() or x.shape[-1] != WORDS:
        raise ValueError(f"{name}: want contiguous int32 (..., {WORDS}) words,"
                         f" got {x.dtype} {tuple(x.shape)}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels read 16-byte vectors")


def _on_cuda(*ts) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); any other device is refused."""
    kinds = {t.device.type for t in ts if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"no Fr kernel for devices {sorted(kinds)}")


def pass_plan(logn: int) -> list[tuple[int, int]]:
    """The stage ranges (s0, s1) of the pass launches that follow the tile
    of a transform of 2^logn: ceil((logn - TILE_LOG) / PASS_LOG) of them,
    the stages split as evenly as they go, the larger ranges first."""
    left = logn - TILE_LOG
    if left <= 0:
        return []
    k = -(-left // PASS_LOG)
    out, s0 = [], TILE_LOG + 1
    for i in range(k):
        n = left // k + (i < left % k)
        out.append((s0, s0 + n - 1))
        s0 += n
    return out


# -- plain versions (limbs inside, words outside) -----------------------------------

def _butterflies(a: torch.Tensor, s0: int, s1: int,
                 tw: torch.Tensor) -> torch.Tensor:
    """Stages s0..s1 of the DIT transform over dim -2 of (..., n, 16)
    limbs already in bit-reversed order."""
    batch, n = a.shape[:-2], a.shape[-2]
    for s in range(s0, s1 + 1):
        half = 1 << (s - 1)
        blocks = a.reshape(*batch, n >> s, 2 * half, NLIMBS)
        even, odd = blocks[..., :half, :], blocks[..., half:, :]
        v = FR_CTX.mont_mul(odd, tw[half - 1:2 * half - 1])
        a = torch.cat([FR_CTX.add(even, v), FR_CTX.sub(even, v)], -2) \
                 .reshape(*batch, n, NLIMBS)
    return a


def _post_plain(a, post_c, post_t):
    if post_c is not None:
        a = FR_CTX.mont_mul(a, words_to_limbs(post_c))
    if post_t is not None:
        a = FR_CTX.mont_mul(a, words_to_limbs(post_t))
    return a


def _gathered(a: torch.Tensor, mode: int) -> torch.Tensor:
    """The tile's inputs in limbs by gather mode: a as it is; a.b - c of
    (..., 3, n, 16); a, b, a.b of (..., 2, n, 16)."""
    if mode == PRODUCT:
        return FR_CTX.sub(FR_CTX.mont_mul(a[..., 0, :, :], a[..., 1, :, :]),
                          a[..., 2, :, :])
    if mode == AB:
        return torch.stack([a[..., 0, :, :], a[..., 1, :, :], FR_CTX.mont_mul(
            a[..., 0, :, :], a[..., 1, :, :])], -3)
    return a


def ntt_tile_plain(x, logn, tw, pre=None, post_c=None, post_t=None,
                   mode=VALUE):
    """Plain version of the tile launch over (..., n, 8) words: x (by
    `mode`: a.b - c of x's (..., 3, n, 8) words, or a, b and a.b of its
    (..., 2, n, 8) words) times `pre` (natural index), bit-reversed,
    stages 1..min(logn, TILE_LOG); when that is every stage, times
    `post_c` and `post_t`."""
    a = _gathered(words_to_limbs(x), mode)
    if pre is not None:
        a = FR_CTX.mont_mul(a, words_to_limbs(pre))
    a = a[..., torch.from_numpy(_bitrev(logn)).to(a.device), :]
    tlog = min(logn, TILE_LOG)
    a = _butterflies(a, 1, tlog, words_to_limbs(tw))
    if tlog == logn:
        a = _post_plain(a, post_c, post_t)
    return limbs_to_words(a)


def ntt_pass_plain(x, logn, s0, s1, tw, post_c=None, post_t=None):
    """Plain version of a pass launch: stages s0..s1 of (..., n, 8) words,
    then times `post_c` and `post_t` where given."""
    a = _butterflies(words_to_limbs(x), s0, s1, words_to_limbs(tw))
    return limbs_to_words(_post_plain(a, post_c, post_t))


def pointwise_plain(a, b=None, c=None, k=None):
    """Plain version of the pointwise launch: (a [x b] [- c]) [x k] over
    (..., 8) words, Montgomery products."""
    x = words_to_limbs(a)
    if b is not None:
        x = FR_CTX.mont_mul(x, words_to_limbs(b))
    if c is not None:
        x = FR_CTX.sub(x, words_to_limbs(c))
    if k is not None:
        x = FR_CTX.mont_mul(x, words_to_limbs(k))
    return limbs_to_words(x)


# -- kernel wrappers ------------------------------------------------------------------

def ntt_tile(x, logn, tw, pre=None, post_c=None, post_t=None, mode=VALUE):
    """The tile launch on a card (a new tensor: (..., n, 8) from x's
    (..., n, 8), or in PRODUCT mode (..., 3, n, 8); (..., 3, n, 8) from
    x's (..., 2, n, 8) in AB mode), its plain version on the CPU."""
    if not _on_cuda(x, tw, pre, post_c, post_t):
        return ntt_tile_plain(x, logn, tw, pre, post_c, post_t, mode)
    n = 1 << logn
    _words_check("x", x)
    _words_check("tw", tw, (n - 1, WORDS))
    for name, t, shape in (("pre", pre, (n, WORDS)),
                           ("post_c", post_c, (WORDS,)),
                           ("post_t", post_t, (n, WORDS))):
        if t is not None:
            _words_check(name, t, shape)
    ins = {VALUE: 0, PRODUCT: 3, AB: 2}[mode]   # inputs a transform
    if x.shape[-2] != n or (ins and (x.dim() < 3 or x.shape[-3] != ins)):
        raise ValueError(f"x: want (..., {f'{ins}, ' if ins else ''}{n}, "
                         f"{WORDS}), got {tuple(x.shape)}")
    lead = x.shape[:-3] if ins else x.shape[:-2]
    out = torch.empty(lead + ((3,) if mode == AB else ()) + x.shape[-2:],
                      dtype=x.dtype, device=x.device)
    kernels.KERNELS["fr_ntt_tile"](x, out, tw, pre, post_c, post_t,
                                   out.numel() // (n * WORDS), logn,
                                   min(logn, TILE_LOG), mode)
    return out


def ntt_pass(x, logn, s0, s1, tw, post_c=None, post_t=None):
    """Stages s0..s1 (TILE_LOG < s0 <= s1 <= logn, at most PASS_LOG of
    them) on a card, in place on x (returned); its plain version on the
    CPU (a new tensor)."""
    if not _on_cuda(x, tw, post_c, post_t):
        return ntt_pass_plain(x, logn, s0, s1, tw, post_c, post_t)
    n = 1 << logn
    _words_check("x", x)
    _words_check("tw", tw, (n - 1, WORDS))
    for name, t, shape in (("post_c", post_c, (WORDS,)),
                           ("post_t", post_t, (n, WORDS))):
        if t is not None:
            _words_check(name, t, shape)
    if x.shape[-2] != n or not TILE_LOG < s0 <= s1 <= logn or \
            s1 - s0 >= PASS_LOG:
        raise ValueError(f"stages {s0}..{s1} of 2^{logn} on "
                         f"{tuple(x.shape)}")
    kernels.KERNELS["fr_ntt_pass"](x, tw, post_c, post_t,
                                   x.numel() // (n * WORDS), logn, s0, s1)
    return x


def pointwise(a, b=None, c=None, k=None):
    """(a [x b] [- c]) [x k] over (..., 8) words: the pointwise launch on
    a card, its plain version on the CPU. b, c have a's shape, k is (8,)."""
    if not _on_cuda(a, b, c, k):
        return pointwise_plain(a, b, c, k)
    _words_check("a", a)
    for name, t, shape in (("b", b, a.shape), ("c", c, a.shape),
                           ("k", k, (WORDS,))):
        if t is not None:
            _words_check(name, t, shape)
    if a.numel() // WORDS >= 1 << 31:
        raise ValueError("pointwise: more than 2^31 values")
    out = torch.empty_like(a)
    kernels.KERNELS["fr_pointwise"](a, b, c, k, out, a.numel() // WORDS)
    return out


def ntt_words(x, logn: int, invert: bool = False, pre=None, post_c=None,
              post_t=None, mode=VALUE):
    """Transform of length 2^logn over dim -2 of (..., n, 8) words, in
    Montgomery form: out[i] = sum_j (x_j pre_j) w^(ij), w^-1 with `invert`,
    then times `post_c` and `post_t[i]` (None: no factor); in PRODUCT mode
    x is (..., 3, n, 8) words a, b, c and x_j = a_j b_j - c_j; in AB mode
    x is (..., 2, n, 8) words a, b and the output (..., 3, n, 8) the
    transforms of a, b and a.b. The inverse's 1/n is the caller's to pass
    in `post_c`. One tile launch and one for each range of
    `pass_plan(logn)` on a card."""
    dev = device_key(x.device)
    tw, _ = word_tables(logn, invert, dev)
    x = x.contiguous()
    post = (post_c, post_t)
    plan = pass_plan(logn)
    out = ntt_tile(x, logn, tw, pre, *(post if not plan else (None, None)),
                   mode=mode)
    for s0, s1 in plan:
        out = ntt_pass(out, logn, s0, s1, tw,
                       *(post if s1 == logn else (None, None)))
    return out


# -- the limb signature -----------------------------------------------------------------

def ntt_plain(a: torch.Tensor, logn: int, invert: bool = False) -> torch.Tensor:
    """Plain NTT over the second-last dim of (..., n, 16) Montgomery limbs
    on any device: out[i] = sum_j a_j w^(ij); with `invert`, the inverse
    (1/n folded in)."""
    rev, tw, n_inv = _stage_consts(logn, invert, device_key(a.device))
    a = _butterflies(a[..., rev, :], 1, logn, tw)
    if invert:
        a = FR_CTX.mont_mul(a, n_inv)
    return a


def _limbs_via_words(a, logn, invert, pre=None, post_t=None):
    dev = device_key(a.device)
    post_c = fr_const(fr_inv(1 << logn), dev) if invert else None
    return words_to_limbs(ntt_words(limbs_to_words(a.contiguous()), logn,
                                    invert, pre, post_c, post_t))


def ntt(a: torch.Tensor, logn: int, invert: bool = False) -> torch.Tensor:
    """NTT over the second-last dim of (..., n, 16) Montgomery limbs:
    out[i] = sum_j a_j w^(ij); with `invert`, the inverse (1/n folded in).
    Through `ntt_words`: the kernels on a card, their plain versions on the
    CPU."""
    return _limbs_via_words(a, logn, invert)


def intt(a: torch.Tensor, logn: int) -> torch.Tensor:
    return ntt(a, logn, invert=True)


def coset_ntt_plain(a: torch.Tensor, logn: int, g: int) -> torch.Tensor:
    return ntt_plain(FR_CTX.mont_mul(
        a, _coset_consts(logn, g, False, device_key(a.device))), logn)


def coset_intt_plain(a: torch.Tensor, logn: int, g: int) -> torch.Tensor:
    return FR_CTX.mont_mul(ntt_plain(a, logn, invert=True),
                           _coset_consts(logn, g, True, device_key(a.device)))


def coset_ntt(a: torch.Tensor, logn: int, g: int) -> torch.Tensor:
    """Evaluate on the coset g<w>: NTT(a_i g^i)."""
    return _limbs_via_words(a, logn, False, pre=coset_words(
        logn, g, False, device_key(a.device)))


def coset_intt(a: torch.Tensor, logn: int, g: int) -> torch.Tensor:
    """Inverse of coset_ntt."""
    return _limbs_via_words(a, logn, True, post_t=coset_words(
        logn, g, True, device_key(a.device)))
