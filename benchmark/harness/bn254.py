"""Plain BN254 arithmetic for the benchmark's reference: the two fields, the
curve's G1 over Fq and G2 over Fq2 (the D-twist y^2 = x^3 + 3/(9+u)), and
multiplication of a generator by a scalar.

Written from the curve's published constants (EIP-196/197, arkworks'
ark-bn254) in Python ints, with no code of the program under test. Points
are affine tuples (x, y), None for infinity; an Fq2 element is a pair
(c0, c1) meaning c0 + c1 u with u^2 = -1.
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1 = (1, 2)
G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


class Fq:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)

    @staticmethod
    def is_zero(a):
        return a % Q == 0


class Fq2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q,
                (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def inv(a):
        t = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
        return (a[0] * t % Q, -a[1] * t % Q)

    @staticmethod
    def is_zero(a):
        return a[0] % Q == 0 and a[1] % Q == 0


def _double(F, p):
    """Jacobian doubling on y^2 = x^3 + b (dbl-2009-l)."""
    x, y, z = p
    if F.is_zero(z) or F.is_zero(y):
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
    z3 = F.mul(y, z)
    return (x3, y3, F.add(z3, z3))


def _add_affine(F, p, q):
    """Jacobian p plus affine q (madd-2007-bl), with its special cases."""
    x1, y1, z1 = p
    if F.is_zero(z1):
        return (q[0], q[1], F.one)
    z1z1 = F.mul(z1, z1)
    u2 = F.mul(q[0], z1z1)
    s2 = F.mul(F.mul(q[1], z1), z1z1)
    h = F.sub(u2, x1)
    rr = F.sub(s2, y1)
    if F.is_zero(h):
        return _double(F, p) if F.is_zero(rr) else (F.one, F.one, F.zero)
    hh = F.mul(h, h)
    i = F.add(hh, hh)
    i = F.add(i, i)
    j = F.mul(h, i)
    rr = F.add(rr, rr)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.mul(rr, rr), j), F.add(v, v))
    y1j = F.mul(y1, j)
    y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.add(y1j, y1j))
    t = F.add(z1, h)
    z3 = F.sub(F.sub(F.mul(t, t), z1z1), hh)
    return (x3, y3, z3)


def _to_affine(F, p):
    x, y, z = p
    if F.is_zero(z):
        return None
    zi = F.inv(z)
    zi2 = F.mul(zi, zi)
    return (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))


def _mul(F, base, k: int):
    k %= R
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:] if k else "":
        acc = _double(F, acc)
        if bit == "1":
            acc = _add_affine(F, acc, base)
    return _to_affine(F, acc)


def g1_mul(k: int, base=G1):
    """k * base in G1, affine (None for infinity)."""
    return _mul(Fq, base, k)


def g2_mul(k: int, base=G2):
    """k * base in G2, affine (None for infinity)."""
    return _mul(Fq2, base, k)
