# Copied from infimum_tpu/curve/bn254_host.py; the port keeps its own host layers.
"""Host (python-int) BN254 G1/G2 group operations.

Ground truth for the device MSM kernels and the building block of the Groth16
setup/verifier. Matches ark-bn254 semantics (the verifier the reference pallet
runs, pallet/src/lib.rs:815-827): E: y^2 = x^3 + 3 over Fq; G2 on the D-twist
y^2 = x^3 + 3/(9+u) over Fq2 with u^2 = -1.

Points are affine tuples (x, y) with None for infinity; Fq2 elements are
(c0, c1) int tuples.
"""

from __future__ import annotations

import functools

from ..ff.bn254 import FQ_MOD as Q, FR_MOD

# Generators (standard BN254 / alt_bn128 values).
G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

B1 = 3
# b2 = 3 / (9 + u)
def _fq2_inv(a):
    c0, c1 = a
    norm = (c0 * c0 + c1 * c1) % Q
    inv = pow(norm, -1, Q) if norm else 0
    return (c0 * inv % Q, (-c1) * inv % Q)


def _fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % Q, (a0 * b1 + a1 * b0) % Q)


def _fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def _fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def _fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


B2 = _fq2_mul((3, 0), _fq2_inv((9, 1)))


class _FqOps:
    zero = 0
    one = 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return (a * b) % Q

    @staticmethod
    def neg(a):
        return (-a) % Q

    @staticmethod
    def inv(a):
        a %= Q
        return pow(a, -1, Q) if a else 0

    @staticmethod
    def eq(a, b):
        return a % Q == b % Q


class _Fq2Ops:
    zero = (0, 0)
    one = (1, 0)
    add = staticmethod(_fq2_add)
    sub = staticmethod(_fq2_sub)
    mul = staticmethod(_fq2_mul)
    neg = staticmethod(_fq2_neg)
    inv = staticmethod(_fq2_inv)

    @staticmethod
    def eq(a, b):
        return a[0] % Q == b[0] % Q and a[1] % Q == b[1] % Q


def _make_group(F, b):
    three = F.add(F.add(F.one, F.one), F.one)

    def is_on_curve(p):
        if p is None:
            return True
        x, y = p
        return F.eq(F.add(F.mul(F.mul(x, x), x), b), F.mul(y, y))

    def double(p):
        if p is None:
            return None
        x, y = p
        if F.eq(y, F.zero):
            return None
        l = F.mul(F.mul(F.mul(x, x), three), F.inv(F.add(y, y)))
        nx = F.sub(F.mul(l, l), F.add(x, x))
        ny = F.sub(F.mul(l, F.sub(x, nx)), y)
        return (nx, ny)

    def add(p, q):
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if F.eq(x1, x2):
            if F.eq(y1, y2):
                return double(p)
            return None
        l = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        nx = F.sub(F.mul(l, l), F.add(x1, x2))
        ny = F.sub(F.mul(l, F.sub(x1, nx)), y1)
        return (nx, ny)

    def neg(p):
        if p is None:
            return None
        return (p[0], F.neg(p[1]))

    def mul(p, n):
        n = n % FR_MOD if n >= FR_MOD or n < 0 else n
        result = None
        addend = p
        while n:
            if n & 1:
                result = add(result, addend)
            addend = double(addend)
            n >>= 1
        return result

    return is_on_curve, double, add, neg, mul


g1_is_on_curve, g1_double, g1_add, g1_neg, g1_mul = _make_group(_FqOps, B1)
g2_is_on_curve, g2_double, g2_add, g2_neg, g2_mul = _make_group(_Fq2Ops, B2)


# -- Jacobian fast paths (setup/prover host math; no per-op inversions) -------

def _make_jacobian(F, affine_add):
    """Jacobian group ops: (mul, dbl, add_affine, add_jac, to_affine).
    ~100x faster than the affine ops above for large scalars since they defer
    the single field inversion."""

    def dbl(p):
        x, y, z = p
        if F.eq(y, F.zero):
            return (F.one, F.one, F.zero)
        a = F.mul(x, x)
        b = F.mul(y, y)
        c = F.mul(b, b)
        t = F.add(x, b)
        d = F.sub(F.sub(F.mul(t, t), a), c)
        d = F.add(d, d)
        e = F.add(F.add(a, a), a)
        f = F.mul(e, e)
        x3 = F.sub(f, F.add(d, d))
        c8 = F.add(c, c)
        c8 = F.add(c8, c8)
        c8 = F.add(c8, c8)
        y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
        z3 = F.mul(F.add(y, y), z)
        return (x3, y3, z3)

    def add(p, q_aff):
        """Jacobian p + affine q."""
        x1, y1, z1 = p
        if F.eq(z1, F.zero):
            return (q_aff[0], q_aff[1], F.one)
        x2, y2 = q_aff
        z1z1 = F.mul(z1, z1)
        u2 = F.mul(x2, z1z1)
        s2 = F.mul(F.mul(y2, z1), z1z1)
        if F.eq(u2, x1):
            if F.eq(s2, y1):
                return dbl(p)
            return (F.one, F.one, F.zero)
        h = F.sub(u2, x1)
        hh = F.mul(h, h)
        i = F.add(F.add(hh, hh), F.add(hh, hh))
        j = F.mul(h, i)
        r = F.sub(s2, y1)
        r = F.add(r, r)
        v = F.mul(x1, i)
        x3 = F.sub(F.sub(F.mul(r, r), j), F.add(v, v))
        y3 = F.sub(F.mul(r, F.sub(v, x3)), F.add(F.mul(y1, j), F.mul(y1, j)))
        z3 = F.mul(F.add(z1, z1), h)
        return (x3, y3, z3)

    def to_affine(p):
        x, y, z = p
        if F.eq(z, F.zero):
            return None
        zi = F.inv(z)
        zi2 = F.mul(zi, zi)
        return (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))

    def add_jac(p, q):
        """General Jacobian p + q."""
        x1, y1, z1 = p
        x2, y2, z2 = q
        if F.eq(z1, F.zero):
            return q
        if F.eq(z2, F.zero):
            return p
        z1z1 = F.mul(z1, z1)
        z2z2 = F.mul(z2, z2)
        u1 = F.mul(x1, z2z2)
        u2 = F.mul(x2, z1z1)
        s1 = F.mul(F.mul(y1, z2), z2z2)
        s2 = F.mul(F.mul(y2, z1), z1z1)
        if F.eq(u1, u2):
            if F.eq(s1, s2):
                return dbl(p)
            return (F.one, F.one, F.zero)
        h = F.sub(u2, u1)
        i = F.add(h, h)
        i = F.mul(i, i)
        j = F.mul(h, i)
        r = F.sub(s2, s1)
        r = F.add(r, r)
        v = F.mul(u1, i)
        x3 = F.sub(F.sub(F.mul(r, r), j), F.add(v, v))
        sj = F.mul(s1, j)
        y3 = F.sub(F.mul(r, F.sub(v, x3)), F.add(sj, sj))
        z3 = F.mul(F.sub(F.mul(F.add(z1, z2), F.add(z1, z2)),
                         F.add(z1z1, z2z2)), h)
        return (x3, y3, z3)

    def mul(p_aff, n):
        if p_aff is None:
            return None
        n %= FR_MOD
        acc = (F.one, F.one, F.zero)
        for bit in bin(n)[2:]:
            acc = dbl(acc)
            if bit == "1":
                acc = add(acc, p_aff)
        return to_affine(acc)

    return mul, dbl, add, add_jac, to_affine


(g1_mul_fast, _g1_jdbl, _g1_jadd_aff, _g1_jadd, _g1_to_aff) = \
    _make_jacobian(_FqOps, g1_add)
(g2_mul_fast, _g2_jdbl, _g2_jadd_aff, _g2_jadd, _g2_to_aff) = \
    _make_jacobian(_Fq2Ops, g2_add)

_JAC = {
    "g1": (_FqOps, _g1_jdbl, _g1_jadd_aff, _g1_jadd, _g1_to_aff),
    "g2": (_Fq2Ops, _g2_jdbl, _g2_jadd_aff, _g2_jadd, _g2_to_aff),
}


def msm_host_fast(points, scalars, curve: str = "g1", c: int = 8):
    """Host Pippenger MSM over python ints (Jacobian accumulation).

    The CPU-side prover path for problem sizes below the device threshold —
    same result as the TPU kernel (msm/pippenger.py), same role as snarkjs's
    host MSM (reference cli/src/utils.ts:69-92)."""
    F, jdbl, jadd_aff, jadd, to_aff = _JAC[curve]
    inf = (F.one, F.one, F.zero)
    pairs = [(p, s % FR_MOD) for p, s in zip(points, scalars)
             if p is not None and s % FR_MOD]
    if not pairs:
        return None
    nwin = (254 + c - 1) // c
    acc = inf
    for w in range(nwin - 1, -1, -1):
        if acc != inf:
            for _ in range(c):
                acc = jdbl(acc)
        buckets = [None] * (1 << c)
        shift = c * w
        mask = (1 << c) - 1
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = jadd_aff(inf, p) if b is None else jadd_aff(b, p)
        run = inf
        tot = inf
        for d in range(mask, 0, -1):
            if buckets[d] is not None:
                run = jadd(run, buckets[d])
            tot = jadd(tot, run)
        acc = jadd(acc, tot)
    return to_aff(acc)


def fixed_base_mul_host(scalars, curve: str = "g1", c: int = 8):
    """Host windowed fixed-base: [s * GEN] for many s, shared 2^c table."""
    F, jdbl, jadd_aff, jadd, to_aff = _JAC[curve]
    gen = G1_GEN if curve == "g1" else G2_GEN
    tab = _fixed_base_table(curve, c)
    inf = (F.one, F.one, F.zero)
    mask = (1 << c) - 1
    out = []
    for s in scalars:
        s %= FR_MOD
        acc = inf
        w = 0
        while s:
            d = s & mask
            if d:
                acc = jadd_aff(acc, tab[w][d])
            s >>= c
            w += 1
        out.append(to_aff(acc))
    return out


@functools.lru_cache(maxsize=None)
def _fixed_base_table(curve: str, c: int):
    """tab[w][d] = d * 2^(c*w) * GEN as affine points (d=0 slot unused)."""
    add = g1_add if curve == "g1" else g2_add
    dbl = g1_double if curve == "g1" else g2_double
    gen = G1_GEN if curve == "g1" else G2_GEN
    nwin = (254 + c - 1) // c
    tab = []
    base = gen
    for _ in range(nwin):
        row = [None]
        acc = base
        for _d in range(1, 1 << c):
            row.append(acc)
            acc = add(acc, base)
        tab.append(row)
        for _ in range(c):
            base = dbl(base)
    return tab
