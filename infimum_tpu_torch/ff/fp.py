"""Batched Montgomery arithmetic over BN254 Fr and Fq in plain PyTorch.

Counterpart of `infimum_tpu/ff/fp.py` `FpCtx`. A field element is a
(..., 16) int64 tensor of 16-bit little-endian limbs, Montgomery R = 2^256,
so every value equals the reference's limb for limb. Limbs live in int64
because torch's uint32 lacks add, shift, compare and index ops; a product of
two limbs is < 2^32 and a schoolbook column of 16 such products < 2^36, so
int64 is exact throughout.

Every op works on the last dim only and broadcasts over the leading dims.
This is the plain version the CPU tests hold against the reference: the
arithmetic of the kernels' plain versions (the NTT, row evaluation and
pointwise steps run it on the CPU; on a card they are CUDA kernels over
words, `limbs_to_words`), and what the fixed-base setup runs on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .bn254 import FQ_MOD, FR_MOD
from .limbs import (
    LIMB_BITS, LIMB_MASK, NLIMBS, batch_from_limbs, batch_to_limbs,
)


def device_key(device) -> str:
    """The name of one device, for the caches of tensors kept per device:
    a bare "cuda" is the current card, so each rank of a process group
    keys its constants on its own card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def int_limbs(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NLIMBS)]


def to_tensor(limbs, device) -> torch.Tensor:
    """numpy uint32 limbs -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(limbs).astype(np.int64)).to(device)


def ints_to_tensor(xs, device) -> torch.Tensor:
    """python ints (each < 2^256) -> (N, 16) int64 limb tensor."""
    return to_tensor(batch_to_limbs(xs), device)


def tensor_to_ints(a: torch.Tensor) -> list[int]:
    """(..., 16) limb tensor -> python ints, flattened over leading dims."""
    return batch_from_limbs(a.reshape(-1, NLIMBS).cpu().numpy())


def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """(..., 2k) int64 16-bit limbs -> (..., k) int32 words (the bit
    pattern of the kernels' uint32 words)."""
    w = a[..., 0::2] | (a[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> (..., 2k) int64 16-bit limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], -1).flatten(-2)


def _lm(*xs):
    """Broadcast, then move the limb dim to the front: (n, *batch) each.
    The ripple loops below then step over contiguous (*batch) slices."""
    xs = torch.broadcast_tensors(*xs)
    return [x.movedim(-1, 0).contiguous() for x in xs]


def _unlm(x):
    return x.movedim(0, -1)


def carry(cols: torch.Tensor):
    """Ripple carry over (n, *batch) limb-major non-negative int64 columns.

    Returns ((n, *batch) 16-bit limbs, (*batch) carry-out)."""
    t = cols.clone()
    for k in range(t.shape[0] - 1):
        t[k + 1] += t[k] >> LIMB_BITS
    return t & LIMB_MASK, t[-1] >> LIMB_BITS


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """Limb-major a - b mod 2^(16n); returns (limbs, borrow in {0, 1})."""
    d = a - b
    for k in range(d.shape[0] - 1):
        d[k + 1] += d[k] >> LIMB_BITS     # arithmetic shift: -1 on borrow
    return d & LIMB_MASK, -(d[-1] >> LIMB_BITS)


def mul_cols(a: torch.Tensor, b: torch.Tensor, ncols: int) -> torch.Tensor:
    """Limb-major schoolbook product columns of a * b (each (n, *batch)),
    the first `ncols` of 2n; column k < 16 * 2^32 = 2^36."""
    n = a.shape[0]
    cols = torch.zeros((ncols, *a.shape[1:]), dtype=torch.int64,
                       device=a.device)
    for i in range(min(n, ncols)):
        w = min(n, ncols - i)
        cols[i:i + w] += a[i] * b[:w]
    return cols


class FpCtx:
    """Montgomery context for one 254-bit prime (R = 2^256)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.R = 1 << (NLIMBS * LIMB_BITS)
        self.R2 = self.R * self.R % modulus
        self.nprime = (-pow(modulus, -1, self.R)) % self.R
        self.one_mont_int = self.R % modulus
        self.r_inv = pow(self.R, -1, modulus)
        self._consts: dict = {}

    def consts(self, device):
        """(N, N', R^2 mod N, 1 in Montgomery form) limb tensors on `device`."""
        key = device_key(device)
        c = self._consts.get(key)
        if c is None:
            c = tuple(torch.tensor(int_limbs(v), dtype=torch.int64,
                                   device=device)
                      for v in (self.modulus, self.nprime, self.R2,
                                self.one_mont_int))
            self._consts[key] = c
        return c

    # -- host-side conversions -------------------------------------------------

    def to_mont_int(self, x: int) -> int:
        return x * self.R % self.modulus

    # -- batched ops: public (..., 16) layout outside, limb-major inside ------

    def _col(self, i, like):
        """Constant i of consts() shaped (16, 1, ...) to broadcast on `like`."""
        return self.consts(like.device)[i].view(-1, *([1] * (like.dim() - 1)))

    def _cond_sub_n(self, r, c):
        """r + c*2^256 - N when that is >= 0, else r."""
        d, borrow = sub_borrow(r, self._col(0, r))
        return torch.where((c > 0) | (borrow == 0), d, r)

    def _add(self, a, b):
        s, c = carry(a + b)
        return self._cond_sub_n(s, c)

    def _sub(self, a, b):
        d, borrow = sub_borrow(a, b)
        plus_n, _ = carry(d + self._col(0, d))
        return torch.where(borrow > 0, plus_n, d)

    def _redc(self, t):
        """(32, *batch) columns of T < N*R -> T * R^-1 mod N, reduced."""
        t_low, _ = carry(t[:NLIMBS])
        m, _ = carry(mul_cols(t_low, self._col(1, t), NLIMBS))
        s, c = carry(t + mul_cols(m, self._col(0, t), 2 * NLIMBS))
        return self._cond_sub_n(s[NLIMBS:], c)

    def add(self, a, b):
        return _unlm(self._add(*_lm(a, b)))

    def sub(self, a, b):
        return _unlm(self._sub(*_lm(a, b)))

    def neg(self, a):
        """-a mod N (a reduced; 0 -> 0)."""
        (x,) = _lm(a)
        d, _ = sub_borrow(self._col(0, x), x)
        return _unlm(torch.where((x == 0).all(0), x, d))

    def mont_mul(self, a, b):
        x, y = _lm(a, b)
        return _unlm(self._redc(mul_cols(x, y, 2 * NLIMBS)))

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

    def to_mont(self, a):
        return self.mont_mul(a, self.consts(a.device)[2])

    def from_mont(self, a):
        (x,) = _lm(a)
        return _unlm(self._redc(torch.cat([x, torch.zeros_like(x)])))

    def one(self, shape, device):
        return self.consts(device)[3].expand(*shape, NLIMBS)

    def mont_pow(self, a, e: int):
        result = self.one(a.shape[:-1], a.device)
        base = a
        while e > 0:
            if e & 1:
                result = self.mont_mul(result, base)
            base = self.mont_sqr(base)
            e >>= 1
        return result

    def mont_inv(self, a):
        """Batched inversion via Fermat (0 maps to 0)."""
        return self.mont_pow(a, self.modulus - 2)

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)

    # -- host helpers -------------------------------------------------------------

    def encode(self, xs, device="cpu") -> torch.Tensor:
        """python ints -> (N, 16) Montgomery limbs."""
        return ints_to_tensor([self.to_mont_int(x % self.modulus) for x in xs],
                              device)

    def decode(self, a) -> list[int]:
        """(..., 16) Montgomery limbs -> python ints."""
        return [x * self.r_inv % self.modulus for x in tensor_to_ints(a)]


FR_CTX = FpCtx(FR_MOD)
FQ_CTX = FpCtx(FQ_MOD)
