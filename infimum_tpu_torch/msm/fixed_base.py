"""Batched fixed-base scalar multiplication [s_i * GEN] in plain PyTorch.

Counterpart of `infimum_tpu/msm/fixed_base.py` (XLA there, not Pallas): the
workload of Groth16 setup, where every key element is a known scalar times a
generator. Windowed tables: the host builds tab[w][d] = d * 2^(c*w) * GEN
once per curve; each scalar then gathers one affine point per c-bit window
and folds the 256/c windows with the complete mixed add, skipping digit 0.
No doublings. Scalars run in chunks to bound the products' memory.
"""

from __future__ import annotations

import functools

import torch

from ..curve.proj import CURVES, CurveDev, G1_DEV
from ..ff.fp import NLIMBS, ints_to_tensor
from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.ff.limbs import LIMB_BITS

CHUNK = 1 << 17


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


def fixed_base_mul_batch(scalars, curve: CurveDev = G1_DEV, device="cpu",
                         c: int = 8):
    """[s * GEN for s in scalars] as host affine points (None for 0)."""
    if not scalars:
        return []
    tab = _window_table(curve.name, c, str(torch.device(device)))
    sc = ints_to_tensor([s % FR_MOD for s in scalars], device)
    parts = [_mul_chunk(curve, tab, sc[i:i + CHUNK], c)
             for i in range(0, sc.shape[0], CHUNK)]
    return curve.decode(tuple(torch.cat(p) for p in zip(*parts)))
