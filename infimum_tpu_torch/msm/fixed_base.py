"""Batched fixed-base scalar multiplication [s_i * GEN].

Counterpart of `infimum_tpu/msm/fixed_base.py` (an XLA program there,
not Pallas): the workload of Groth16 setup, where every key element is a
known scalar times a generator. Windowed tables: the host builds
tab[w][d] = d * 2^(c*w) * GEN once per curve; each scalar then gathers one
affine point per c-bit window and folds the 256/c windows with the
complete mixed add, skipping digit 0. No doublings.

On a card one launch of `csrc/fixed_base.cu` covers every scalar of a
call (`mul_words`, c = 8) and hands back affine standard-form words, x
then y, (0, 0) for infinity: the kernel takes its points to affine with
one inversion a block of GROUP points. Its plain version
`mul_words_plain` runs `_mul_chunk` in plain torch over chunks of
scalars, then `normalize_plain`; affine coordinates are unique, so the
two give the same words bit for bit. `decode_words` only turns the words
into host ints: the JAX package decodes projective points on the host
(one batched Z inversion there), the port on the card.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .. import kernels
from ..curve.proj import CURVES, CurveDev, G1_DEV
from ..ff.bn254 import FQ_MOD
from ..ff.fp import (
    FQ_CTX, NLIMBS, device_key, ints_to_tensor, limbs_to_words,
    tensor_to_ints, words_to_limbs,
)
from ..ff.fq2 import FQ2_CTX
from ..ff.limbs import LIMB_BITS
from ..groth16.rowval import ints_to_words

C = 8                                  # = kC, csrc/fixed_base.cu
N_WINDOWS = (NLIMBS * LIMB_BITS) // C  # = kWindows: 32
CHUNK = 1 << 17      # scalars a `_mul_chunk` of the plain version
WORDS = NLIMBS // 2
GROUP = 128          # = kFixedBlock: points sharing the kernel's inversion


@functools.lru_cache(maxsize=None)
def _window_table(curve_name: str, c: int, device: str) -> torch.Tensor:
    """(nwin * 2^c, 2, field shape) Montgomery affine table; the digit-0
    slots hold the generator and are never used."""
    curve = CURVES[curve_name]
    nb = 1 << c
    rows = []
    base = curve.gen
    for _ in range((NLIMBS * LIMB_BITS) // c):
        acc = None
        for _d in range(nb):
            rows.append(acc if acc is not None else curve.gen)
            acc = curve.host_add(acc, base)
        base = curve.host_mul(base, nb)
    return curve.encode_affine(rows, device)


@functools.lru_cache(maxsize=None)
def table_words(curve_name: str, device: str) -> torch.Tensor:
    """The c = 8 window table as the kernel reads it: (N_WINDOWS << C, 2W)
    int32 words a row, x then y, made once per curve and card."""
    tab = _window_table(curve_name, C, device)
    return limbs_to_words(tab.reshape(tab.shape[0], -1)).contiguous()


def _mul_chunk(curve: CurveDev, tab: torch.Tensor, sc: torch.Tensor, c: int):
    """(n, 16) standard-form scalar limbs -> projective (X, Y, Z)."""
    nb = 1 << c
    per_limb = LIMB_BITS // c
    acc = curve.infinity((sc.shape[0],), sc.device)
    for w in range((NLIMBS * LIMB_BITS) // c):
        digit = (sc[:, w // per_limb] >> ((w % per_limb) * c)) & (nb - 1)
        pt = tab[w * nb + digit]
        summed = curve.add_mixed(acc, (pt[:, 0], pt[:, 1]))
        acc = curve.select(digit != 0, summed, acc)
    return acc


def _inverses(d: torch.Tensor) -> torch.Tensor:
    """(n, 16) nonzero Montgomery limbs of values d -> (n, 16) standard-form
    limbs of 1/d, by Montgomery's trick as a product tree: pairs
    multiplied level by level up to one root, the root inverted on the
    host, then each node's inverse times its sibling's product down to
    the leaves (3 products a value)."""
    levels = [d]
    while levels[-1].shape[0] > 1:
        x = levels[-1]
        if x.shape[0] % 2:
            x = torch.cat([x, FQ_CTX.one((1,), x.device)])
        levels.append(FQ_CTX.mont_mul(x[0::2], x[1::2]))
    # the root's word is t R: its plain inverse is (t R)^-1, so 1/t is
    # R times it
    (root,) = tensor_to_ints(levels[-1])
    inv = ints_to_tensor([pow(root, -1, FQ_MOD) * (1 << 256) % FQ_MOD],
                         d.device)
    for x in reversed(levels[:-1]):
        m = x.shape[0]
        if m % 2:
            x = torch.cat([x, FQ_CTX.one((1,), x.device)])
        pair = FQ_CTX.mont_mul(inv.unsqueeze(1).expand(-1, 2, -1),
                               x.unflatten(0, (-1, 2)).flip(1))
        inv = pair.flatten(0, 1)[:m]
    return inv


def normalize_plain(proj: torch.Tensor, curve: CurveDev = G1_DEV
                    ) -> torch.Tensor:
    """(n, 3W) projective Montgomery words -> (n, 2W) affine standard-form
    words, x then y, (0, 0) for infinity: the kernel's epilogue in plain
    torch (one product tree over all n, not a tree a block)."""
    if proj.shape[0] == 0:
        return proj.new_zeros((0, 2 * WORDS * curve.fdims))
    limbs = words_to_limbs(proj).unflatten(-1, (3, *curve.fshape()))
    x, y, z = limbs[:, 0], limbs[:, 1], limbs[:, 2]
    if curve.fdims == 1:
        d = z
    else:
        sq = FQ_CTX.mont_mul(z, z)
        d = FQ_CTX.add(sq[:, 0], sq[:, 1])
    live = (d != 0).any(-1)
    k = _inverses(torch.where(live.unsqueeze(-1), d,
                              FQ_CTX.one(d.shape[:1], d.device)))
    if curve.fdims == 1:
        zi = k
        xy = FQ_CTX.mont_mul(torch.stack([x, y]), zi)
    else:      # Z^-1 = conj(Z) / d
        zk = FQ_CTX.mont_mul(z, k.unsqueeze(1))
        zi = torch.stack([zk[:, 0], FQ_CTX.neg(zk[:, 1])], 1)
        xy = FQ2_CTX.mont_mul(torch.stack([x, y]), zi.expand(2, *zi.shape))
    xy = torch.where(live.view(1, -1, *([1] * (xy.dim() - 2))), xy, 0)
    return limbs_to_words(torch.cat([xy[0].flatten(1), xy[1].flatten(1)],
                                    1))


def mul_words_plain(sc: torch.Tensor, curve: CurveDev = G1_DEV,
                    c: int = C) -> torch.Tensor:
    """The plain version of `mul_words` on any device: `_mul_chunk` over
    chunks of CHUNK scalars, then `normalize_plain`."""
    tab = _window_table(curve.name, c, device_key(sc.device))
    limbs = words_to_limbs(sc)
    parts = [torch.cat([t.flatten(1) for t in
                        _mul_chunk(curve, tab, limbs[i:i + CHUNK], c)], 1)
             for i in range(0, limbs.shape[0], CHUNK)]
    if not parts:
        return torch.zeros((0, 2 * WORDS * curve.fdims), dtype=torch.int32,
                           device=sc.device)
    return normalize_plain(limbs_to_words(torch.cat(parts)), curve)


def mul_words(sc: torch.Tensor, curve: CurveDev = G1_DEV,
              c: int = C) -> torch.Tensor:
    """(n, 8) int32 standard-form scalar words below r -> (n, 2W) int32
    affine standard-form words of s * GEN, x then y, (0, 0) for infinity
    (W = 8 for G1, 16 for G2, c0 then c1): one launch of the fixed-base
    kernel on a card, its plain version on the CPU."""
    if sc.device.type == "cpu":
        return mul_words_plain(sc, curve, c)
    if sc.device.type != "cuda":
        raise ValueError(f"no fixed_base kernel for {sc.device}")
    if c != C:
        raise ValueError(f"the fixed_base kernel takes c = {C}, not {c}")
    if sc.dtype != torch.int32 or sc.dim() != 2 or sc.shape[1] != WORDS \
            or not sc.is_contiguous() or sc.data_ptr() % 16:
        raise ValueError(f"sc: want contiguous 16-byte aligned (n, {WORDS}) "
                         f"int32 words, got {sc.dtype} {tuple(sc.shape)}")
    if sc.shape[0] >= 1 << 31:
        raise ValueError("fixed_base: more than 2^31 scalars")
    tab = table_words(curve.name, device_key(sc.device))
    out = torch.empty((sc.shape[0], 2 * WORDS * curve.fdims),
                      dtype=torch.int32, device=sc.device)
    if sc.shape[0]:
        kernels.KERNELS[f"fixed_base_{curve.name}"](sc, tab, out,
                                                    sc.shape[0])
    return out


def decode_words(out: torch.Tensor, curve: CurveDev = G1_DEV):
    """(n, 2W) affine standard-form words -> host affine points (None for
    (0, 0)): each 32-byte coordinate read as an int, no field arithmetic.
    (A fixed-width bytes array drops each coordinate's trailing zero
    bytes, its top bytes: the little-endian value stays.)"""
    vals = list(map(int.from_bytes, np.frombuffer(
        out.cpu().numpy().tobytes(), dtype="S32").tolist(),
        itertools.repeat("little")))
    if curve.fdims == 1:
        return [p if p[0] or p[1] else None
                for p in zip(vals[0::2], vals[1::2])]
    xs = zip(vals[0::4], vals[1::4])
    ys = zip(vals[2::4], vals[3::4])
    return [(x, y) if any(x) or any(y) else None for x, y in zip(xs, ys)]


def fixed_base_mul_batch(scalars, curve: CurveDev = G1_DEV, device="cuda",
                         c: int = C):
    """[s * GEN for s in scalars] as host affine points (None for 0)."""
    if not scalars:
        return []
    # reduced mod r: the kernel's digits need scalars below r
    return decode_words(mul_words(ints_to_words(scalars, device), curve, c),
                        curve)
