"""Batched Fq2 = Fq[u]/(u^2 + 1) arithmetic in plain PyTorch.

Counterpart of `infimum_tpu/ff/fq2.py`. Elements are (..., 2, 16) int64
tensors: component 0 is the real part, component 1 the u-coefficient, each a
Montgomery Fq limb vector (ff/fp.py). Multiplication is Karatsuba (3 Fq
multiplications), the quadratic non-residue is -1, as in ark-bn254.
"""

from __future__ import annotations

import torch

from .fp import FQ_CTX, NLIMBS
from infimum_tpu.ff.bn254 import FQ_MOD

F = FQ_CTX


class Fq2Ctx:
    """FpCtx's op surface for Fq2 elements (..., 2, 16)."""

    def __init__(self):
        self.modulus = FQ_MOD

    # component-wise ops broadcast straight through the trailing (2, 16) dims
    def add(self, a, b):
        return F.add(a, b)

    def sub(self, a, b):
        return F.sub(a, b)

    def neg(self, a):
        return F.neg(a)

    def mont_mul(self, a, b):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        # one batched Fq product for the three Karatsuba terms
        t = F.mont_mul(torch.stack([a0, a1, F.add(a0, a1)]),
                       torch.stack([b0, b1, F.add(b0, b1)]))
        t0, t1, cross = t.unbind(0)
        c0 = F.sub(t0, t1)                       # u^2 = -1
        c1 = F.sub(F.sub(cross, t0), t1)
        return torch.stack([c0, c1], -2)

    def mont_sqr(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        # (a0 + a1)(a0 - a1), 2 a0 a1
        c0 = F.mont_mul(F.add(a0, a1), F.sub(a0, a1))
        t = F.mont_mul(a0, a1)
        return torch.stack([c0, F.add(t, t)], -2)

    def one(self, shape, device):
        one = F.one((), device)
        return torch.stack([one, torch.zeros_like(one)]).expand(
            *shape, 2, NLIMBS)

    def select(self, cond, a, b):
        """cond ? a : b with cond of batch shape (no trailing field dims)."""
        return torch.where(cond[..., None, None], a, b)


FQ2_CTX = Fq2Ctx()
