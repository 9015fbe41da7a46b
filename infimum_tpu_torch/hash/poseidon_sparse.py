"""The optimized form of circom's Poseidon permutation: folded round
constants and sparse partial rounds (the Poseidon paper's App. B, the form
of circomlib's optimized `poseidon.circom`).

The reference's permutation (`poseidon_host.poseidon_perm_py`) runs
R_F + R_P rounds, each s <- M * sbox(s + c_r) with m[i] = sum_j M[i][j] s[j],
the S-box on every element in a full round and on element 0 in a partial
one. The same function, with the same output, in the optimized form:

    s += C[0:t]
    4 full rounds:  s <- sbox(s); s += C[t(r+1) : t(r+2)]; s <- M s
                    (the fourth mixes with P in place of M)
    R_P partial:    s0 <- sbox(s0) + C[5t + j]
                    s0' = sum_k S_j[k] s[k]; s[k] += S_j[t + k - 1] s0
    4 full rounds:  s <- sbox(s); s += C[5t + R_P + t(r-4) ...]; s <- M s
                    (the last adds no constants)

How the tables follow from the Grain parameters, mod r:
- Constants. c_{r+1}, added after round r's mix, equals M^-1 c_{r+1} added
  before it. In a partial round only element 0 of that vector has to stay
  after the S-box; the rest commutes with the S-box and moves back through
  the previous round's mix, last partial round first, until the full round
  before the partial ones absorbs it. So C holds t * R_F + R_P values.
- Matrices. Write M = [[a, v^T], [w, A]] (A the lower right block). A
  partial round's matrix N = [[a, v^T], [w', X A]] factors as N = S D with
  D = diag(1, X A), applied first, and S = [[a, u^T], [w', I]] with
  u = (X A)^-T v: D commutes with the partial S-box, so it moves into the
  round before, whose matrix becomes D M. From the last partial round
  back (X = I there), X is a power of A: round j of R_P has
  w' = A^(R_P-1-j) w and u^T = v^T A^-(R_P-j), and the full round before
  the partial ones mixes with P = diag(1, A^R_P) M.

The tables are exact: `tests/test_torch_poseidon.py` holds the optimized
form against the reference's permutation at every width.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..ff.bn254 import FR_MOD
from .grain import FULL_ROUNDS, MAX_WIDTH, PARTIAL_ROUNDS, poseidon_params


@dataclass(frozen=True)
class SparseParams:
    """The optimized permutation's tables for one width t, ints mod r.
    c: t * R_F + R_P folded round constants, in the order they are added;
    m: the t x t MDS matrix; p: the t x t matrix of the last full round
    before the partial ones; s: R_P rows of 2t - 1, each a partial round's
    first row (t entries) then its first column below the diagonal."""
    c: list[int]
    m: list[list[int]]
    p: list[list[int]]
    s: list[list[int]]


def _mat_vec(m, v):
    return [sum(a * b for a, b in zip(row, v)) % FR_MOD for row in m]


def _vec_mat(v, m):
    return [sum(v[i] * m[i][j] for i in range(len(v))) % FR_MOD
            for j in range(len(m[0]))]


def _mat_mul(a, b):
    return [_vec_mat(row, b) for row in a]


def _mat_inv(m):
    """Inverse mod r by Gauss-Jordan elimination."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col])
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], FR_MOD - 2, FR_MOD)
        a[col] = [x * inv % FR_MOD for x in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % FR_MOD for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


@functools.lru_cache(maxsize=None)
def sparse_params(t: int) -> SparseParams:
    """The optimized tables of width t, from `poseidon_params(t)`."""
    if not 2 <= t <= MAX_WIDTH:
        raise ValueError(f"unsupported poseidon width {t}")
    ark, mds = poseidon_params(t)
    r_p = PARTIAL_ROUNDS[t - 2]
    half = FULL_ROUNDS // 2
    rounds = FULL_ROUNDS + r_p
    c = [ark[r * t:(r + 1) * t] for r in range(rounds)]
    m_inv = _mat_inv(mds)

    # d[r]: the constants added after round r's S-box, before its mix
    d = [_mat_vec(m_inv, c[r + 1]) for r in range(rounds - 1)]
    k = [0] * r_p
    for r in range(half + r_p - 1, half - 1, -1):      # partial rounds
        k[r - half] = d[r][0]
        back = _mat_vec(m_inv, [0] + d[r][1:])
        d[r - 1] = [(x + y) % FR_MOD for x, y in zip(d[r - 1], back)]
    consts = c[0] + sum(d[:half], []) + k + sum(d[half + r_p:], [])

    a_hat = [row[1:] for row in mds[1:]]
    a_inv = _mat_inv(a_hat)
    v, w = mds[0][1:], [row[0] for row in mds[1:]]
    cols = [w]                            # A^(R_P-1-j) w, last round first
    rows = [_vec_mat(v, a_inv)]           # v^T A^-(R_P-j)
    for _ in range(r_p - 1):
        cols.append(_mat_vec(a_hat, cols[-1]))
        rows.append(_vec_mat(rows[-1], a_inv))
    sparse = [[mds[0][0]] + rows[r_p - 1 - j] + cols[r_p - 1 - j]
              for j in range(r_p)]
    a_pow = a_hat                         # A^R_P
    for _ in range(r_p - 1):
        a_pow = _mat_mul(a_pow, a_hat)
    pre = [mds[0]] + [[x] + y for x, y in zip(_mat_vec(a_pow, w),
                                              _mat_mul(a_pow, a_hat))]
    return SparseParams(consts, mds, pre, sparse)

