"""Radix-2 NTT / iNTT / coset NTT over BN254 Fr in plain PyTorch.

Counterpart of `infimum_tpu/ntt/ntt.py:80-229`: iterative Cooley-Tukey
(decimation in time) on (..., n, 16) Montgomery limb tensors. A bit-reversal
gather, then log2(n) butterfly stages, each one batched `mont_mul` plus an
add and a sub over the whole array; leading dims batch several transforms
through every stage together. Twiddles, the bit-reversal permutation and the
coset powers are built on the host once per size and kept per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff.bn254 import (
    FR_MOD, FR_TWO_ADIC_ROOT, FR_TWO_ADICITY, fr_inv,
)
from ..ff.fp import FR_CTX, NLIMBS, device_key


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


@functools.lru_cache(maxsize=None)
def _stage_consts(logn: int, invert: bool, device: str):
    """(bit-reversal permutation, packed twiddles, 1/n in Montgomery form).

    Stage s (half = 2^(s-1)) uses rows [half-1, 2*half-1) of the packed
    (n-1, 16) twiddle table: w_len^k for k < half, w_len = w^(n / 2^s)."""
    n = 1 << logn
    w = _root_of_unity(n)
    if invert:
        w = fr_inv(w)
    rev = np.zeros(n, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    flat = []
    for s in range(1, logn + 1):
        flat += _powers(pow(w, n >> s, FR_MOD), 1 << (s - 1))
    tw = FR_CTX.encode(flat, device) if flat else torch.zeros(
        (0, NLIMBS), dtype=torch.int64, device=device)
    n_inv = FR_CTX.encode([fr_inv(n)], device)[0]
    return torch.from_numpy(rev).to(device), tw, n_inv


@functools.lru_cache(maxsize=None)
def _coset_consts(logn: int, g: int, invert: bool, device: str):
    """(n, 16) Montgomery powers g^i, or (g^-1)^i when `invert`."""
    return FR_CTX.encode(_powers(fr_inv(g) if invert else g, 1 << logn),
                         device)


def ntt(a: torch.Tensor, logn: int, invert: bool = False) -> torch.Tensor:
    """NTT over the second-last dim of (..., n, 16) Montgomery limbs:
    out[i] = sum_j a_j w^(ij); with `invert`, the inverse (1/n folded in)."""
    n = 1 << logn
    rev, tw, n_inv = _stage_consts(logn, invert, device_key(a.device))
    batch = a.shape[:-2]
    a = a[..., rev, :]
    for s in range(1, logn + 1):
        half = 1 << (s - 1)
        blocks = a.reshape(*batch, n >> s, 2 * half, NLIMBS)
        even, odd = blocks[..., :half, :], blocks[..., half:, :]
        v = FR_CTX.mont_mul(odd, tw[half - 1:2 * half - 1])
        a = torch.cat([FR_CTX.add(even, v), FR_CTX.sub(even, v)], -2) \
                 .reshape(*batch, n, NLIMBS)
    if invert:
        a = FR_CTX.mont_mul(a, n_inv)
    return a


def intt(a: torch.Tensor, logn: int) -> torch.Tensor:
    return ntt(a, logn, invert=True)


def coset_ntt(a: torch.Tensor, logn: int, g: int) -> torch.Tensor:
    """Evaluate on the coset g<w>: NTT(a_i g^i)."""
    return ntt(FR_CTX.mont_mul(a, _coset_consts(logn, g, False, device_key(a.device))),
               logn)


def coset_intt(a: torch.Tensor, logn: int, g: int) -> torch.Tensor:
    """Inverse of coset_ntt."""
    return FR_CTX.mont_mul(intt(a, logn),
                           _coset_consts(logn, g, True, device_key(a.device)))
