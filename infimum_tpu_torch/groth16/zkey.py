"""Groth16 over snarkjs .zkey artifacts: generate, prove, verify.

Counterpart of `infimum_tpu/groth16/zkey.py`, with the same keys, the same
randomness and the same proofs. A coordinator that holds a ceremony zkey
(`snarkjs groth16 setup`) proves against the verifying key deployed from
it; `generate_zkey` lays a single-party setup out in the same format.

prove_zkey, on `device`:
  1. a|_H, b|_H from the zkey's A/B coefficient triples x witness, one
     sparse product per matrix (groth16/rowval.py, built once per zkey and
     device); c|_H = a|_H . b|_H pointwise: the zkey holds no C matrix, and
     a satisfied R1CS makes the product exact on the domain.
  2. P = a.b - c on the odd coset {eta w^i}, eta = w_2m: one batched iNTT
     of the three, one coset NTT with generator eta, the pointwise step
     (groth16.ab_minus_c, as prove()'s H pipeline but without its tail).
     The zkey's H points are that coset's Lagrange basis folded with
     Z(tau)/(-2 delta) (io/snarkjs.py), so P's m values are the h-MSM's
     scalars as they stand: no coset iNTT, no division by Z.
  3. The five MSMs (a, b1, c, h over G1, b2 over G2) through the CUDA MSM
     kernels on a card, their query encodings cached on the zkey; the r, s
     blinding, the assembly and the stage trace are groth16.prove's own
     (`prove_queries`).
"""

from __future__ import annotations

import random

import torch

from ..curve.bn254_host import G1_GEN, G2_GEN, g1_mul_fast, g2_mul_fast
from ..curve.proj import G1_DEV, G2_DEV
from ..ff.bn254 import FR_MOD, fr_inv
from ..ff.fp import FR_CTX
from ..io.snarkjs import ZkeyData
from ..msm.fixed_base import fixed_base_mul_batch
from ..ntt.ntt import _root_of_unity
from .groth16 import (
    Proof, VerifyingKey, ab_minus_c, lagrange_at, prove_queries,
    qap_polys_at_tau,
)
from .r1cs import ConstraintSystem
from .rowval import SparseRows, eval_rows

P = FR_MOD


def generate_zkey(cs: ConstraintSystem, rng: random.Random | None = None,
                  device="cuda") -> ZkeyData:
    """Single-party (test-grade) setup laid out as a zkey; draws tau, alpha,
    beta, gamma, delta from `rng` in the reference's order, so one seed
    gives the same zkey."""
    rng = rng or random.SystemRandom()
    tau = rng.randrange(1, P)
    alpha = rng.randrange(1, P)
    beta = rng.randrange(1, P)
    gamma = rng.randrange(1, P)
    delta = rng.randrange(1, P)

    u, v, wpoly, z_tau, m = qap_polys_at_tau(cs, tau)
    nv = cs.num_vars
    npub = cs.num_public + 1
    gamma_inv, delta_inv = fr_inv(gamma), fr_inv(delta)

    # H basis: L_i(tau/eta) * Z(tau) / (-2 delta), eta = w_2m
    eta = _root_of_unity(2 * m)
    lag_shift = lagrange_at(tau * fr_inv(eta) % P, m)
    hz = z_tau * fr_inv((P - 2) * delta % P) % P
    h_s = [lj * hz % P for lj in lag_shift]

    ic_s = [(beta * u[i] + alpha * v[i] + wpoly[i]) % P * gamma_inv % P
            for i in range(npub)]
    c_s = [(beta * u[i] + alpha * v[i] + wpoly[i]) % P * delta_inv % P
           for i in range(npub, nv)]
    g1 = fixed_base_mul_batch(ic_s + c_s + u + v + h_s, G1_DEV, device)
    off = npub + len(c_s)

    # the coefficient section: A and B only (C is A.B on the domain), and
    # the public-input rows snarkjs appends to A (row ncons + i)
    coeffs = []
    ncons = len(cs.constraints)
    for j, (a, b, _c) in enumerate(cs.constraints):
        coeffs.extend((0, j, sig, val) for sig, val in sorted(a.terms.items()))
        coeffs.extend((1, j, sig, val) for sig, val in sorted(b.terms.items()))
    coeffs.extend((0, ncons + i, i, 1) for i in range(npub))

    return ZkeyData(
        n_vars=nv, n_public=cs.num_public, domain_size=m,
        alpha_g1=g1_mul_fast(G1_GEN, alpha),
        beta_g1=g1_mul_fast(G1_GEN, beta),
        beta_g2=g2_mul_fast(G2_GEN, beta),
        gamma_g2=g2_mul_fast(G2_GEN, gamma),
        delta_g1=g1_mul_fast(G1_GEN, delta),
        delta_g2=g2_mul_fast(G2_GEN, delta),
        ic=g1[:npub], coeffs=coeffs,
        a_query=g1[off:off + nv], b1_query=g1[off + nv:off + 2 * nv],
        b2_query=fixed_base_mul_batch(v, G2_DEV, device),
        c_query=g1[npub:off], h_query=g1[off + 2 * nv:],
    )


def vk_from_zkey(zk: ZkeyData) -> VerifyingKey:
    return VerifyingKey(alpha_g1=zk.alpha_g1, beta_g2=zk.beta_g2,
                        gamma_g2=zk.gamma_g2, delta_g2=zk.delta_g2,
                        ic=list(zk.ic))


def zkey_rows(zk: ZkeyData, device) -> SparseRows:
    """The zkey's A and B triples on `device`, flattened once per device."""
    cache = zk.__dict__.setdefault("_torch_sparse_rows", {})
    key = str(torch.device(device))
    if key not in cache:
        mats = {"A": ([], [], []), "B": ([], [], [])}
        for mat, row, sig, val in zk.coeffs:
            coeffs, cols, rids = mats["AB"[mat]]
            coeffs.append(val)
            cols.append(sig)
            rids.append(row)
        cache[key] = SparseRows(mats, zk.domain_size, device)
    return cache[key]


def odd_coset_rows(zk: ZkeyData, witness: list[int], device) -> torch.Tensor:
    """(m, 16) standard-form limbs of P = a.b - c on the odd coset
    {eta w^i} on `device`: the h-MSM's scalars against the zkey's H
    points."""
    m = zk.domain_size
    logm = m.bit_length() - 1
    if 1 << logm != m:
        raise ValueError("zkey domain size must be a power of two")
    a, b = eval_rows(zkey_rows(zk, device), witness, m)
    abc = torch.stack([a, b, FR_CTX.mont_mul(a, b)])
    return ab_minus_c(abc, logm, _root_of_unity(2 * m), divide_z=False)


def prove_zkey(zk: ZkeyData, witness: list[int],
               rng: random.Random | None = None, device="cuda") -> Proof:
    """A proof under vk_from_zkey(zk); draws r, s from `rng` as the
    reference does, so one seed gives the reference's proof. Its stages
    are recorded in groth16.LAST_PROVE_TRACE, as prove()'s are."""
    return prove_queries(
        zk, (("a", zk.a_query), ("b1", zk.b1_query), ("b2", zk.b2_query),
             ("c", zk.c_query), ("h", zk.h_query)),
        lambda: (odd_coset_rows(zk, witness, device), None),
        witness, zk.n_public + 1, rng, device)
