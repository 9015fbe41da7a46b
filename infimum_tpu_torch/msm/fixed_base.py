"""Batched fixed-base scalar multiplication [s_i * GEN].

Counterpart of `infimum_tpu/msm/fixed_base.py` (an XLA program there,
not Pallas): the workload of Groth16 setup, where every key element is a
known scalar times a generator. Windowed tables: the host builds
tab[w][d] = d * 2^(c*w) * GEN once per curve; each scalar then gathers one
affine point per c-bit window and folds the 256/c windows with the
complete mixed add, skipping digit 0. No doublings.

On a card one launch of `csrc/fixed_base.cu` covers every scalar of a
call (`mul_words`, c = 8); its plain version `mul_words_plain` runs
`_mul_chunk` in plain torch over chunks of scalars, in the kernel's order,
so the two give the same projective words bit for bit. The points are
decoded on the host, as the JAX package decodes them.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..curve.proj import CURVES, CurveDev, G1_DEV
from ..ff.fp import NLIMBS, device_key, limbs_to_words, words_to_limbs
from ..ff.limbs import LIMB_BITS
from ..groth16.rowval import ints_to_words

C = 8                                  # = kC, csrc/fixed_base.cu
N_WINDOWS = (NLIMBS * LIMB_BITS) // C  # = kWindows: 32
CHUNK = 1 << 17      # scalars a `_mul_chunk` of the plain version
WORDS = NLIMBS // 2


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


def mul_words_plain(sc: torch.Tensor, curve: CurveDev = G1_DEV,
                    c: int = C) -> torch.Tensor:
    """The plain version of `mul_words` on any device: `_mul_chunk` over
    chunks of CHUNK scalars."""
    tab = _window_table(curve.name, c, device_key(sc.device))
    limbs = words_to_limbs(sc)
    parts = [torch.cat([t.flatten(1) for t in
                        _mul_chunk(curve, tab, limbs[i:i + CHUNK], c)], 1)
             for i in range(0, limbs.shape[0], CHUNK)]
    if not parts:
        return torch.zeros((0, 3 * WORDS * curve.fdims), dtype=torch.int32,
                           device=sc.device)
    return limbs_to_words(torch.cat(parts))


def mul_words(sc: torch.Tensor, curve: CurveDev = G1_DEV,
              c: int = C) -> torch.Tensor:
    """(n, 8) int32 standard-form scalar words below r -> (n, 3W) int32
    projective words of s * GEN, X then Y then Z (W = 8 for G1, 16 for
    G2): one launch of the fixed-base kernel on a card, its plain version
    on the CPU."""
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
    out = torch.empty((sc.shape[0], 3 * WORDS * curve.fdims),
                      dtype=torch.int32, device=sc.device)
    if sc.shape[0]:
        kernels.KERNELS[f"fixed_base_{curve.name}"](sc, tab, out,
                                                    sc.shape[0])
    return out


def decode_words(out: torch.Tensor, curve: CurveDev = G1_DEV):
    """(n, 3W) projective words -> host affine points (None for infinity)."""
    limbs = words_to_limbs(out).unflatten(-1, (3, *curve.fshape()))
    return curve.decode((limbs[:, 0], limbs[:, 1], limbs[:, 2]))


def fixed_base_mul_batch(scalars, curve: CurveDev = G1_DEV, device="cuda",
                         c: int = C):
    """[s * GEN for s in scalars] as host affine points (None for 0)."""
    if not scalars:
        return []
    # reduced mod r: the kernel's digits need scalars below r
    return decode_words(mul_words(ints_to_words(scalars, device), curve, c),
                        curve)
