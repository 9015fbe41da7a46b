# Copied from infimum_tpu/curve/pairing.py; the port keeps its own host layers.
"""BN254 optimal-ate pairing on the host — the Groth16 verifier's engine.

Equivalent in behavior to ark-bn254's pairing (which the reference pallet's
verifier uses, pallet/src/lib.rs:822-824). Fq12 is represented as the polynomial
quotient ring Fq[w] / (w^12 - 18 w^6 + 82), with G2 points mapped onto the curve
over Fq12 via the twist; the Miller loop runs over the ate loop count 6x+2 and
the final exponentiation is staged as (p^6-1), (p^2+1), (p^4-p^2+1)/r.

Speed is adequate for verification and tests (a multi-pairing is a few seconds);
bulk proving work never touches this path.
"""

from __future__ import annotations

from ..ff.bn254 import FQ_MOD as Q, FR_MOD as R, BN_X

ATE_LOOP_COUNT = 6 * BN_X + 2
_LOG_ATE = ATE_LOOP_COUNT.bit_length() - 2

# w^12 = 18 w^6 - 82
_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)
_DEG = 12


class FQ12:
    __slots__ = ("c",)

    def __init__(self, coeffs):
        self.c = [x % Q for x in coeffs]
        assert len(self.c) == _DEG

    @classmethod
    def one(cls):
        return cls([1] + [0] * 11)

    @classmethod
    def zero(cls):
        return cls([0] * 12)

    def __add__(self, o):
        return FQ12([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return FQ12([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return FQ12([-a for a in self.c])

    def __eq__(self, o):
        return self.c == o.c

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ12([a * o for a in self.c])
        b = [0] * (2 * _DEG - 1)
        for i, ai in enumerate(self.c):
            if ai:
                for j, bj in enumerate(o.c):
                    b[i + j] += ai * bj
        # reduce by w^12 = 18w^6 - 82
        for i in range(2 * _DEG - 2, _DEG - 1, -1):
            top = b[i]
            if top:
                b[i] = 0
                b[i - 6] += top * 18
                b[i - 12] -= top * 82
        return FQ12(b[:_DEG])

    def __pow__(self, e):
        result = FQ12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        # extended Euclid over Fq[w] modulo the ring polynomial
        lm, hm = [1] + [0] * _DEG, [0] * (_DEG + 1)
        low = self.c + [0]
        high = list(_MOD_COEFFS) + [1]

        def deg(p):
            d = len(p) - 1
            while d and p[d] % Q == 0:
                d -= 1
            return d

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            binv = pow(b[degb], Q - 2, Q)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % Q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % Q
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (_DEG + 1 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(_DEG + 1):
                for j in range(_DEG + 1 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                    new[i + j] = (new[i + j] - low[i] * r[j]) % Q
            lm, low, hm, high = nm, new, lm, low
        linv = pow(low[0], Q - 2, Q)
        return FQ12([x * linv % Q for x in lm[:_DEG]])


_W = FQ12([0, 1] + [0] * 10)
_W2 = _W * _W
_W3 = _W2 * _W


def twist(pt):
    """G2 affine point ((x0,x1),(y0,y1)) -> point on E(Fq12)."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    nx = FQ12([x0 - 9 * x1] + [0] * 5 + [x1] + [0] * 5)
    ny = FQ12([y0 - 9 * y1] + [0] * 5 + [y1] + [0] * 5)
    return (nx * _W2, ny * _W3)


def cast_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _double(p):
    x, y = p
    l = x * x * 3 * (y + y).inv()
    nx = l * l - (x + x)
    ny = l * (x - nx) - y
    return (nx, ny)


def _add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        return _double(p)
    if x1 == x2:
        return None
    l = (y2 - y1) * (x2 - x1).inv()
    nx = l * l - (x1 + x2)
    ny = l * (x1 - nx) - y1
    return (nx, ny)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at point t (all on E(Fq12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 == x2 and y1 == y2:
        m_num = x1 * x1 * 3
        m_den = y1 + y1
        return m_num * (xt - x1) - m_den * (yt - y1)
    if x1 == x2:
        return xt - x1
    m_num = y2 - y1
    m_den = x2 - x1
    return m_num * (xt - x1) - m_den * (yt - y1)


def miller_loop(q_g2, p_g1):
    """f_{6x+2,Q}(P) with the two BN frobenius line corrections; NO final exp."""
    if q_g2 is None or p_g1 is None:
        return FQ12.one()
    q = twist(q_g2)
    p = cast_g1(p_g1)
    r = q
    f = FQ12.one()
    for i in range(_LOG_ATE, -1, -1):
        f = f * f * _linefunc(r, r, p)
        r = _double(r)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * _linefunc(r, q, p)
            r = _add(r, q)
    q1 = (q[0] ** Q, q[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * _linefunc(r, q1, p)
    r = _add(r, q1)
    f = f * _linefunc(r, nq2, p)
    return f


def final_exponentiate(f):
    """f^((q^12-1)/r), staged: easy part via (q^6-1)(q^2+1), then hard part."""
    e1 = f ** (Q ** 6 - 1)
    e2 = e1 ** (Q ** 2 + 1)
    return e2 ** ((Q ** 4 - Q ** 2 + 1) // R)


def pairing(p_g1, q_g2):
    return final_exponentiate(miller_loop(q_g2, p_g1))


def multi_pairing_is_one(pairs) -> bool:
    """prod e(Pi, Qi) == 1, with a single shared final exponentiation."""
    f = FQ12.one()
    for p_g1, q_g2 in pairs:
        f = f * miller_loop(q_g2, p_g1)
    return final_exponentiate(f) == FQ12.one()
