"""Complete projective BN254 G1/G2 arithmetic in plain PyTorch.

Counterpart of `infimum_tpu/curve/proj.py` `CurveDev`: the Renes-Costello-
Batina (2016) complete formulas for a = 0 curves in homogeneous projective
coordinates, one straight-line formula for P+Q, P+P, P+(-P) and infinity
(0, 1, 0). Points are tuples (X, Y, Z) of field tensors: (..., 16) Fq limbs
for G1, (..., 2, 16) Fq2 limbs for G2, Montgomery form. The products of each
formula are grouped into a few batched `mont_mul` calls, as in the
reference, which here cuts the number of eager launches.
"""

from __future__ import annotations

import torch

from ..ff.fp import FQ_CTX, NLIMBS, ints_to_tensor, tensor_to_ints
from ..ff.fq2 import FQ2_CTX
from infimum_tpu.curve.bn254_host import (
    B2, G1_GEN, G2_GEN, _fq2_mul, g1_add, g1_double, g1_mul, g2_add,
    g2_double, g2_mul,
)
from infimum_tpu.ff.bn254 import FQ_MOD, batch_inv_mod


class CurveDev:
    """Batched ops for one curve; `fdims` = number of trailing field dims."""

    def __init__(self, F, fdims, b3, host_ops, gen, name):
        self.F = F
        self.fdims = fdims
        self._b3 = b3               # 3b as host ints: (c,) for G1, (c0, c1) for G2
        self._b3_dev: dict = {}
        self.host_add, self.host_double, self.host_mul = host_ops
        self.gen = gen
        self.name = name

    def fshape(self, batch_shape=()):
        return (*batch_shape, *((2,) * (self.fdims - 1)), NLIMBS)

    def b3(self, device):
        """3b in Montgomery form, shape (field shape)."""
        key = str(torch.device(device))
        t = self._b3_dev.get(key)
        if t is None:
            t = FQ_CTX.encode(list(self._b3), device).reshape(self.fshape())
            self._b3_dev[key] = t
        return t

    def one(self, batch_shape, device):
        return self.F.one(batch_shape, device)

    def infinity(self, batch_shape, device):
        zero = torch.zeros(self.fshape(batch_shape), dtype=torch.int64,
                           device=device)
        return (zero, self.one(batch_shape, device).contiguous(), zero)

    def select(self, cond, p, q):
        return tuple(self.F.select(cond, a, b) for a, b in zip(p, q))

    # -- grouped field ops ----------------------------------------------------------

    def _gmul(self, lhs, rhs):
        return self.F.mont_mul(torch.stack(lhs), torch.stack(rhs)).unbind(0)

    def _gadd(self, lhs, rhs):
        return self.F.add(torch.stack(lhs), torch.stack(rhs)).unbind(0)

    def _gsub(self, lhs, rhs):
        return self.F.sub(torch.stack(lhs), torch.stack(rhs)).unbind(0)

    # -- RCB complete addition (a = 0), Alg. 7 ------------------------------------

    def add(self, p, q):
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        b3 = self.b3(X1.device).expand_as(X1)
        a1, a2, a3, b1, b2, b31 = self._gadd(
            (X1, Y1, X1, X2, Y2, X2), (Y1, Z1, Z1, Y2, Z2, Z2))
        t0, t1, t2, s3, s4, s5 = self._gmul(
            (X1, Y1, Z1, a1, a2, a3), (X2, Y2, Z2, b1, b2, b31))
        t2b = F.mont_mul(t2, b3)
        u1, u2, u3, X3, Z3 = self._gadd(
            (t0, t1, t0, t0, t1), (t1, t2, t2, t0, t2b))
        t3, t4, Y3u, t1n = self._gsub((s3, s4, s5, t1), (u1, u2, u3, t2b))
        t0n = F.add(X3, t0)
        # Y3 is used unscaled; the two products that need b3*Y3 are scaled
        # afterwards (the constant commutes through the product)
        p0, p1, p2, p3, p4, p5 = self._gmul(
            (t4, t3, Y3u, t1n, t0n, Z3), (Y3u, t1n, t0n, Z3, t3, t4))
        q0, q2 = self._gmul((p0, p2), (b3, b3))
        return (F.sub(p1, q0), F.add(p3, q2), F.add(p5, p4))

    # -- RCB mixed addition (Q affine, never infinity), Alg. 8 ----------------

    def add_mixed(self, p, q_aff):
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2 = q_aff
        b3 = self.b3(X1.device).expand_as(X1)
        a1, b1 = self._gadd((X1, X2), (Y1, Y2))
        t0, t1, s2, s3, s4, t2 = self._gmul(
            (X1, Y1, a1, Z1, Z1, Z1), (X2, Y2, b1, Y2, X2, b3))
        u1, t4, Y3u0, X3, Z3 = self._gadd(
            (t0, s3, s4, t0, t1), (t1, Y1, X1, t0, t2))
        t3, t1n = self._gsub((s2, t1), (u1, t2))
        t0n = F.add(X3, t0)
        p0, p1, p2, p3, p4, p5 = self._gmul(
            (t4, t3, Y3u0, t1n, t0n, Z3), (Y3u0, t1n, t0n, Z3, t3, t4))
        q0, q2 = self._gmul((p0, p2), (b3, b3))
        return (F.sub(p1, q0), F.add(p3, q2), F.add(p5, p4))

    def neg(self, p):
        x, y, z = p
        return (x, self.F.neg(y), z)

    # -- host conversions -------------------------------------------------------

    def encode_affine(self, points, device="cpu") -> torch.Tensor:
        """Host affine points (no infinities) -> (N, 2, field shape) Montgomery
        limbs: one byte-packing pass on the host, `to_mont` on `device`."""
        flat: list[int] = []
        for pt in points:
            if pt is None:
                raise ValueError("affine encoding cannot represent infinity")
            if self.fdims == 1:
                flat += (pt[0], pt[1])
            else:
                flat += (pt[0][0], pt[0][1], pt[1][0], pt[1][1])
        std = ints_to_tensor([v % FQ_MOD for v in flat], device)
        return FQ_CTX.to_mont(std).reshape(len(points), 2,
                                           *self.fshape())

    def decode(self, p):
        """Batched projective points -> host affine points / None.

        Coordinates leave Montgomery form on the tensor's device; the Z
        inversions are batched on the host (one modexp for the batch)."""
        xs, ys, zs = (self._felts(FQ_CTX.from_mont(c)) for c in p)
        if self.fdims == 1:
            live = [z for z in zs if z]
            invs = iter(batch_inv_mod(live, FQ_MOD))
            out = []
            for x, y, z in zip(xs, ys, zs):
                if z == 0:
                    out.append(None)
                else:
                    zi = next(invs)
                    out.append((x * zi % FQ_MOD, y * zi % FQ_MOD))
            return out
        # (a + bu)^-1 = (a - bu) / (a^2 + b^2): one batched Fq inversion
        norms = [(z[0] * z[0] + z[1] * z[1]) % FQ_MOD for z in zs if z != (0, 0)]
        ninvs = iter(batch_inv_mod(norms, FQ_MOD))
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == (0, 0):
                out.append(None)
            else:
                ni = next(ninvs)
                zi = (z[0] * ni % FQ_MOD, (FQ_MOD - z[1]) * ni % FQ_MOD)
                out.append((_fq2_mul(x, zi), _fq2_mul(y, zi)))
        return out

    def decode_one(self, p):
        return self.decode(tuple(c.unsqueeze(0) for c in p))[0]

    def _felts(self, a):
        vals = tensor_to_ints(a)
        if self.fdims == 1:
            return vals
        return [tuple(vals[i:i + 2]) for i in range(0, len(vals), 2)]


G1_DEV = CurveDev(FQ_CTX, 1, (9,), (g1_add, g1_double, g1_mul), G1_GEN,
                  "g1")                                  # b = 3, so 3b = 9
G2_DEV = CurveDev(FQ2_CTX, 2, tuple(3 * c % FQ_MOD for c in B2),
                  (g2_add, g2_double, g2_mul), G2_GEN, "g2")
CURVES = {"g1": G1_DEV, "g2": G2_DEV}
