# Copied from infimum_tpu/curve/babyjubjub.py; the port keeps its own host layers.
"""BabyJubJub twisted Edwards curve over BN254 Fr (host ops).

The in-circuit key/signature arithmetic of the reference circuits
(reference: circuits/utils/babyjub.circom, priv-to-pub-key.circom:14-20):
a*x^2 + y^2 = 1 + d*x^2*y^2 with a=168700, d=168696; generator point Base8 of
the prime-order subgroup (order l below, cofactor 8).
"""

from __future__ import annotations

from .. import native
from ..ff.bn254 import FR_MOD as P

A = 168700
D = 168696

BASE8 = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)

# Prime order of the large subgroup (cofactor 8).
SUB_ORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041


def add(p, q):
    """Twisted Edwards addition (complete), in native C++
    (native/src/bjj.cc)."""
    return native.bjj_add(p, q)


def double(p):
    return add(p, p)


def neg(p):
    return ((-p[0]) % P, p[1])


IDENTITY = (0, 1)


def _ext_add(p, q):
    """Unified extended-coordinate addition (X, Y, T, Z), Hisil et al.
    "add-2008-hwcd": no inversions — an affine addition costs two modular
    inverses per step. Complete here because d is a non-square and a a
    square mod P."""
    x1, y1, t1, z1 = p
    x2, y2, t2, z2 = q
    a = x1 * x2 % P
    b = y1 * y2 % P
    c = D * t1 % P * t2 % P
    dd = z1 * z2 % P
    e = ((x1 + y1) * (x2 + y2) - a - b) % P
    f = (dd - c) % P
    g = (dd + c) % P
    h = (b - A * a) % P
    return (e * f % P, g * h % P, e * h % P, f * g % P)


def mul(p, n: int):
    """Scalar multiplication: native C++ (native/src/bjj.cc, ~60 us at
    full width, the host hot loop of EdDSA signing and ECDH in message
    publication and replay) for scalars below 2^256, which it reads in 32
    bytes; above, via extended coordinates in Python, one inversion in
    all (the final normalization)."""
    n = int(n)
    if n <= 0:
        return IDENTITY if n == 0 else mul(neg(p), -n)
    if n < (1 << 256):
        return native.bjj_mul(p, n)
    x, y = p
    acc = (0, 1, 0, 1)                       # identity
    base = (x, y, x * y % P, 1)
    while n > 0:
        if n & 1:
            acc = _ext_add(acc, base)
        base = _ext_add(base, base)
        n >>= 1
    xr, yr, _, zr = acc
    if zr == 0:
        return IDENTITY
    zi = pow(zr, -1, P)
    return (xr * zi % P, yr * zi % P)


def is_on_curve(p) -> bool:
    x, y = p
    x2 = x * x % P
    y2 = y * y % P
    return (A * x2 + y2) % P == (1 + D * x2 % P * y2) % P


# -- point (de)compression (reference circuits/utils/pointbits.circom) --------

SIGN_THRESHOLD = (P - 1) // 2   # CompConstant((p-1)/2): sign(x) = x > this


def fr_sqrt(n: int) -> int | None:
    """Canonical square root mod P (Tonelli-Shanks; P-1 = 2^28 * odd),
    returned in the 'non-negative' half [0, (P-1)/2] like the circom
    sqrt() helper (pointbits.circom:27-70), or None if no root exists."""
    n %= P
    if n == 0:
        return 0
    if pow(n, (P - 1) // 2, P) != 1:
        return None
    s, q = 0, P - 1
    while q % 2 == 0:
        s += 1
        q //= 2
    z = 5                       # Fr's standard non-residue generator
    c = pow(z, q, P)
    t = pow(n, q, P)
    r = pow(n, (q + 1) // 2, P)
    m = s
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m = i
        c = b * b % P
        t = t * c % P
        r = r * b % P
    return r if r <= SIGN_THRESHOLD else P - r


def pack_point(p: tuple[int, int]) -> int:
    """Point2Bits_Strict (pointbits.circom:137-164): 256-bit word with
    bits 0..253 = y, bit 254 = 0, bit 255 = sign(x) = x > (p-1)/2."""
    x, y = p
    assert 0 <= x < P and 0 <= y < P
    sign = 1 if x > SIGN_THRESHOLD else 0
    return y | (sign << 255)


def unpack_point(v: int) -> tuple[int, int]:
    """Bits2Point_Strict (pointbits.circom:78-126): recover (x, y) from the
    packed word; raises ValueError on a non-canonical y, a set bit 254, or
    a y with no curve point."""
    if v >> 256:
        raise ValueError("packed point exceeds 256 bits")
    if (v >> 254) & 1:
        raise ValueError("bit 254 must be zero")
    y = v & ((1 << 254) - 1)
    if y >= P:
        raise ValueError("non-canonical y")
    sign = (v >> 255) & 1
    y2 = y * y % P
    den = (A - D * y2) % P
    if den == 0:
        raise ValueError("no affine x for this y")
    x = fr_sqrt((1 - y2) * pow(den, -1, P) % P)
    if x is None:
        raise ValueError("y is not on the curve")
    if sign:
        x = (P - x) % P
    if (1 if x > SIGN_THRESHOLD else 0) != sign:
        raise ValueError("sign bit inconsistent with recovered x")
    assert is_on_curve((x, y))
    return (x, y)


def in_subgroup(p) -> bool:
    return is_on_curve(p) and mul(p, SUB_ORDER) == IDENTITY
