"""The plain reference that decides `correct`: the Groth16 proof a witness
must get, worked out from the key's trapdoor.

The benchmark draws the proving key's five trapdoor values (tau, alpha,
beta, gamma, delta) from the configuration's key seed, in the order in
which the Groth16 setup of the libsnark/arkworks reduction takes them, and
hands the same seed to the program's key set-up. Knowing them, the proof
of a witness w under random values r and s is three scalars times the
generators, with no multi-scalar multiplication and no H polynomial:

  A = (alpha + a(tau) + r delta) G1
  B = (beta + b(tau) + s delta) G2
  C = ((sum over private i of w_i (beta u_i + alpha v_i + w_i)(tau)
        + a(tau) b(tau) - c(tau)) / delta
       + s A' + r B' - r s delta) G1

where a(x) = sum_i w_i u_i(x) (and b, c alike) over the QAP of the
constraint rows plus one row (x_i, 0, 0) for the constant and each public
input, on the radix-2 domain of the next power of two, A' and B' are the
scalars of A and of B taken in G1, and a(tau) b(tau) - c(tau) =
h(tau) Z(tau) is what the prover's H stage and h-MSM must give. So a fault
in the H stage, in any of the five MSMs or in the assembly changes a point.
The u_i, v_i, w_i at tau come from the Lagrange basis at tau, L_j(tau) =
Z(tau)/m * w^j / (tau - w^j), walked once over the constraint rows.

Inputs are the constraint system (duck-typed: `constraints` as rows of
three linear combinations with a `terms` dict, `num_vars`, `num_public`)
and the witness, both made by the benchmark and handed to the program
alike. Nothing of the program is imported here.
"""

from __future__ import annotations

import hashlib
import random

from .bn254 import R, g1_mul, g2_mul

FR_GENERATOR = 5          # the multiplicative generator of Fr (arkworks)
FR_TWO_ADICITY = 28


def trapdoor(key_seed: int) -> tuple[int, int, int, int, int]:
    """(tau, alpha, beta, gamma, delta) drawn from `key_seed` as the key
    set-up draws them: five randrange(1, r) from random.Random(key_seed)."""
    rng = random.Random(key_seed)
    return tuple(rng.randrange(1, R) for _ in range(5))


def proof_randomness(rng: random.Random) -> tuple[int, int]:
    """(r, s) as the prover draws them: the first two randrange(r) of the
    rng it is handed."""
    return rng.randrange(R), rng.randrange(R)


def domain_size(cs) -> int:
    n = len(cs.constraints) + cs.num_public + 1
    return 1 << (n - 1).bit_length()


def circuit_shape(cs) -> dict:
    """The constraint system's shape as a configuration pins it: its rows,
    variables and public inputs, and a SHA-256 of every row's three linear
    combinations in order, each one's terms sorted by variable: 4 bytes of
    the variable and 32 of its coefficient mod r, little-endian, a term,
    and "|" after each combination."""
    h = hashlib.sha256()
    for row in cs.constraints:
        for lc in row:
            h.update(b"".join(i.to_bytes(4, "little")
                              + (k % R).to_bytes(32, "little")
                              for i, k in sorted(lc.terms.items())))
            h.update(b"|")
    return {"constraints": len(cs.constraints), "num_vars": cs.num_vars,
            "num_public": cs.num_public, "rows_sha256": h.hexdigest()}


def _batch_inv(vals: list[int]) -> list[int]:
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R
    inv = pow(prefix[-1], -1, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * vals[i] % R
    return out


def lagrange_at(tau: int, m: int, count: int) -> list[int]:
    """L_j(tau) for j < count over the radix-2 domain of size m."""
    w = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
    for _ in range(FR_TWO_ADICITY - (m.bit_length() - 1)):
        w = w * w % R
    zm = (pow(tau, m, R) - 1) * pow(m, -1, R) % R
    powers, wj = [], 1
    for _ in range(count):
        powers.append(wj)
        wj = wj * w % R
    invs = _batch_inv([(tau - p) % R for p in powers])
    return [zm * p % R * i % R for p, i in zip(powers, invs)]


class Groth16Reference:
    """The proofs one constraint system's witnesses must get under the key
    drawn from `key_seed`."""

    def __init__(self, cs, key_seed: int):
        self.tau, self.alpha, self.beta, _gamma, self.delta = trapdoor(
            key_seed)
        self.npub = cs.num_public + 1
        nrows = len(cs.constraints) + self.npub
        lag = lagrange_at(self.tau, domain_size(cs), nrows)
        nv = cs.num_vars
        u, v, w = [0] * nv, [0] * nv, [0] * nv
        for lj, (a, b, c) in zip(lag, cs.constraints):
            for i, k in a.terms.items():
                u[i] += k * lj
            for i, k in b.terms.items():
                v[i] += k * lj
            for i, k in c.terms.items():
                w[i] += k * lj
        for i in range(self.npub):    # the rows (x_i, 0, 0)
            u[i] += lag[len(cs.constraints) + i]
        self.u = [x % R for x in u]
        self.v = [x % R for x in v]
        self.w = [x % R for x in w]
        self.delta_inv = pow(self.delta, -1, R)

    def witness_sums(self, witness: list[int]) -> tuple[int, int, int, int]:
        """(a(tau), b(tau), the L query's sum times delta, h(tau) Z(tau)) of
        one witness: the parts of the proof that r and s do not change."""
        a = b = c = 0
        for x, ui, vi, wi in zip(witness, self.u, self.v, self.w):
            if x:
                a += x * ui
                b += x * vi
                c += x * wi
        pa = pb = pc = 0
        for x, ui, vi, wi in zip(witness[:self.npub], self.u, self.v, self.w):
            pa += x * ui
            pb += x * vi
            pc += x * wi
        lsum = (self.beta * (a - pa) + self.alpha * (b - pb) + c - pc) % R
        return a % R, b % R, lsum, (a * b - c) % R

    def scalars(self, sums: tuple[int, int, int, int], r: int, s: int):
        """The scalars of A (G1), B (G2) and C (G1)."""
        a, b, lsum, hz = sums
        sa = (self.alpha + a + r * self.delta) % R
        sb = (self.beta + b + s * self.delta) % R
        sc = ((lsum + hz) * self.delta_inv + s * sa + r * sb
              - r * s % R * self.delta) % R
        return sa, sb, sc

    def proof(self, sums, r: int, s: int):
        """(A, B, C) as affine points."""
        sa, sb, sc = self.scalars(sums, r, s)
        return g1_mul(sa), g2_mul(sb), g1_mul(sc)
