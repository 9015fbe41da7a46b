"""Groth16 over BN254: setup, prover and verifier, on PyTorch tensors.

Counterpart of `infimum_tpu/groth16/groth16.py`, with the same keys, the
same randomness and the same proofs:

  - setup(): the QAP by Lagrange evaluation at tau (libsnark/arkworks
    reduction with the extra public-input rows), every key element a
    fixed-base product on `device` (msm/fixed_base.py).
  - prove(): row evaluation and the H pipeline (3 iNTT + 3 coset NTT, the
    pointwise step and one coset iNTT) stay on `device`; the five MSMs
    (a, b1, l, h over G1 and b2 over G2) are dispatched before any host
    wait, through the CUDA MSM kernels on a card; the proof is assembled on
    the host.
  - verify(): the native C++ pairing (`native`), which reads the keys and
    proofs through `io.arkworks`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from ..curve.bn254_host import (
    G1_GEN, G2_GEN, g1_add, g1_mul_fast, g1_neg, g2_add, g2_mul_fast,
)
from ..curve.proj import G1_DEV, G2_DEV, CurveDev
from ..ff.bn254 import FR_MOD, batch_inv_mod, fr_inv
from ..ff.fp import FR_CTX, NLIMBS, ints_to_tensor, tensor_to_ints
from ..msm.fixed_base import fixed_base_mul_batch
from ..msm.msm import (
    combine_window_points, encode_rows, msm_lanes, msm_rows_async,
)
from ..ntt.ntt import _root_of_unity, coset_ntt, coset_intt, intt
from .r1cs import LC, ConstraintSystem
from .rowval import SparseRows, eval_rows

P = FR_MOD
COSET_GEN = 5  # Fr's standard multiplicative generator (as arkworks)


@dataclass
class ProvingKey:
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_query: list          # [u_i(tau)]_1, all vars
    b_g1_query: list       # [v_i(tau)]_1
    b_g2_query: list       # [v_i(tau)]_2
    l_query: list          # [(beta u_i + alpha v_i + w_i)/delta]_1, witness vars
    h_query: list          # [tau^i Z(tau)/delta]_1, i < m-1
    vk: "VerifyingKey"


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list               # [(beta u_i + alpha v_i + w_i)/gamma]_1, public vars


@dataclass
class Proof:
    a: tuple   # G1
    b: tuple   # G2
    c: tuple   # G1


# -- QAP ---------------------------------------------------------------------------

def _qap_rows(cs: ConstraintSystem):
    """Constraint rows plus the libsnark public-input rows (var_i, 0, 0)."""
    rows = list(cs.constraints)
    for i in range(cs.num_public + 1):
        rows.append((LC.var(i), LC(), LC()))
    return rows


def _domain_size(cs: ConstraintSystem) -> int:
    n = len(cs.constraints) + cs.num_public + 1
    return 1 << (n - 1).bit_length()


def lagrange_at(y: int, m: int) -> list[int]:
    """All m Lagrange-basis polynomials over the radix-2 domain at y:
    L_j(y) = (Z(y)/m) * w^j / (y - w^j)."""
    w = _root_of_unity(m)
    z_y = (pow(y, m, P) - 1) % P
    assert z_y != 0, "evaluation point hit the domain"
    zm = z_y * fr_inv(m) % P
    denoms = []
    wj = 1
    for _ in range(m):
        denoms.append((y - wj) % P)
        wj = wj * w % P
    invs = batch_inv_mod(denoms, P)
    lag = []
    wj = 1
    for j in range(m):
        lag.append(zm * wj % P * invs[j] % P)
        wj = wj * w % P
    return lag


def qap_polys_at_tau(cs: ConstraintSystem, tau: int):
    """(u, v, w) per-variable QAP polynomial evaluations at tau, plus Z(tau)
    and the domain size."""
    rows = _qap_rows(cs)
    m = _domain_size(cs)
    lag = lagrange_at(tau, m)
    z_tau = (pow(tau, m, P) - 1) % P
    nv = cs.num_vars
    u, v, wpoly = [0] * nv, [0] * nv, [0] * nv
    for j, (a, b, c) in enumerate(rows):
        lj = lag[j]
        for i, coeff in a.terms.items():
            u[i] = (u[i] + coeff * lj) % P
        for i, coeff in b.terms.items():
            v[i] = (v[i] + coeff * lj) % P
        for i, coeff in c.terms.items():
            wpoly[i] = (wpoly[i] + coeff * lj) % P
    return u, v, wpoly, z_tau, m


def setup(cs: ConstraintSystem, rng: random.Random | None = None,
          device="cuda") -> ProvingKey:
    """Single-party trusted setup; draws tau, alpha, beta, gamma, delta from
    `rng` in the reference's order, so one seed gives the same key."""
    rng = rng or random.SystemRandom()
    tau = rng.randrange(1, P)
    alpha = rng.randrange(1, P)
    beta = rng.randrange(1, P)
    gamma = rng.randrange(1, P)
    delta = rng.randrange(1, P)

    u, v, wpoly, z_tau, m = qap_polys_at_tau(cs, tau)
    nv = cs.num_vars
    gamma_inv, delta_inv = fr_inv(gamma), fr_inv(delta)
    npub = cs.num_public + 1
    ic_s = [(beta * u[i] + alpha * v[i] + wpoly[i]) % P * gamma_inv % P
            for i in range(npub)]
    l_s = [(beta * u[i] + alpha * v[i] + wpoly[i]) % P * delta_inv % P
           for i in range(npub, nv)]
    h_s = [0] * (m - 1)            # tau^i * Z(tau)/delta
    acc = z_tau * delta_inv % P
    for i in range(m - 1):
        h_s[i] = acc
        acc = acc * tau % P
    g1 = fixed_base_mul_batch(ic_s + l_s + u + v + h_s, G1_DEV, device)
    off = npub + len(l_s)
    vk = VerifyingKey(
        alpha_g1=g1_mul_fast(G1_GEN, alpha),
        beta_g2=g2_mul_fast(G2_GEN, beta),
        gamma_g2=g2_mul_fast(G2_GEN, gamma),
        delta_g2=g2_mul_fast(G2_GEN, delta),
        ic=g1[:npub],
    )
    return ProvingKey(
        alpha_g1=vk.alpha_g1,
        beta_g1=g1_mul_fast(G1_GEN, beta),
        beta_g2=vk.beta_g2,
        delta_g1=g1_mul_fast(G1_GEN, delta),
        delta_g2=vk.delta_g2,
        a_query=g1[off:off + nv],
        b_g1_query=g1[off + nv:off + 2 * nv],
        b_g2_query=fixed_base_mul_batch(v, G2_DEV, device),
        l_query=g1[npub:off],
        h_query=g1[off + 2 * nv:],
        vk=vk,
    )


# -- H pipeline -------------------------------------------------------------------

def sparse_rows(cs: ConstraintSystem, device) -> SparseRows:
    """A/B/C triples of `cs` on `device`, flattened once per device."""
    cache = cs.__dict__.setdefault("_torch_sparse_rows", {})
    key = str(torch.device(device))
    if key not in cache:
        rows = _qap_rows(cs)
        cache[key] = SparseRows(rows, len(rows), device)
    return cache[key]


def h_rows(cs: ConstraintSystem, witness: list[int], device) -> torch.Tensor:
    """(m, 16) standard-form limbs of h's coefficients on `device`: the
    h-MSM's scalars. Row m-1 must be zero (the caller's degree gate)."""
    m = _domain_size(cs)
    logm = m.bit_length() - 1
    abc = torch.stack(eval_rows(sparse_rows(cs, device), witness, m))
    ev = coset_ntt(intt(abc, logm), logm, COSET_GEN)   # 3 transforms batched
    prod = FR_CTX.sub(FR_CTX.mont_mul(ev[0], ev[1]), ev[2])
    z_inv = fr_inv((pow(COSET_GEN, m, P) - 1) % P)
    h_evals = FR_CTX.mont_mul(prod, FR_CTX.encode([z_inv], device)[0])
    return FR_CTX.from_mont(coset_intt(h_evals, logm, COSET_GEN))


def compute_h(cs: ConstraintSystem, witness: list[int], device="cuda"):
    """Coefficients of h(x) = (a(x) b(x) - c(x)) / Z(x) as python ints."""
    h = tensor_to_ints(h_rows(cs, witness, device))
    m = _domain_size(cs)
    assert h[m - 1] == 0, "h has unexpected degree"
    return h[:m - 1]


# -- MSMs over cached proving-key queries -----------------------------------------

def _query_encoding(pk: ProvingKey, name: str, points, curve: CurveDev,
                    device):
    """(rows, infinity mask, lanes) for a proving-key query on `device`,
    encoded once per key; an infinity point is replaced by the generator
    and given a zero scalar."""
    cache = pk.__dict__.setdefault("_torch_enc_cache", {})
    key = (name, str(torch.device(device)))
    ent = cache.get(key)
    if ent is None:
        lanes = msm_lanes(len(points), curve.name)
        none_mask = torch.tensor([p is None for p in points], dtype=torch.bool)
        safe = [curve.gen if p is None else p for p in points]
        ent = (encode_rows(safe, lanes, curve.name, device),
               none_mask.to(device), lanes)
        cache[key] = ent
    return ent


def _msm_async(pk: ProvingKey, name: str, points, scalars: torch.Tensor,
               curve: CurveDev = G1_DEV):
    """Dispatch one query's MSM without a host wait; `scalars` is (n, 16)
    standard-form limbs on the query's device. Returns a closure that waits
    and combines the window sums into the affine result."""
    rows, none_mask, lanes = _query_encoding(pk, name, points, curve,
                                             scalars.device)
    n = scalars.shape[0]
    sc = torch.zeros((rows.shape[0], NLIMBS), dtype=torch.int64,
                     device=scalars.device)
    sc[:n] = torch.where(none_mask[:n].unsqueeze(-1), 0, scalars)
    wins = msm_rows_async(rows, sc, lanes, curve.name)
    return lambda: combine_window_points(wins.cpu(), curve.name)


def prove(pk: ProvingKey, cs: ConstraintSystem, witness: list[int],
          rng: random.Random | None = None, device="cuda") -> Proof:
    rng = rng or random.SystemRandom()
    r = rng.randrange(P)
    s = rng.randrange(P)
    npub = cs.num_public + 1
    m = _domain_size(cs)

    h = h_rows(cs, witness, device)
    w = ints_to_tensor([x % P for x in witness], device)
    a_fin = _msm_async(pk, "a", pk.a_query, w)
    b2_fin = _msm_async(pk, "b2", pk.b_g2_query, w, G2_DEV)
    b1_fin = _msm_async(pk, "b1", pk.b_g1_query, w)
    c_fin = _msm_async(pk, "l", pk.l_query, w[npub:])
    h_fin = _msm_async(pk, "h", pk.h_query, h[:m - 1])
    # degree gate: one row read back, queued behind the MSM dispatches
    if bool(h[m - 1].any()):
        raise AssertionError("h has unexpected degree")
    a_acc, b2_acc, b1_acc = a_fin(), b2_fin(), b1_fin()
    c_acc, h_acc = c_fin(), h_fin()

    # A = alpha + sum + r*delta
    pi_a = g1_add(g1_add(pk.alpha_g1, a_acc), g1_mul_fast(pk.delta_g1, r))
    # B = beta + sum + s*delta
    pi_b = g2_add(g2_add(pk.beta_g2, b2_acc), g2_mul_fast(pk.delta_g2, s))
    b_g1 = g1_add(g1_add(pk.beta_g1, b1_acc), g1_mul_fast(pk.delta_g1, s))
    # C = L + H + s*A + r*B1 - r*s*delta
    pi_c = g1_add(c_acc, h_acc)
    pi_c = g1_add(pi_c, g1_mul_fast(pi_a, s))
    pi_c = g1_add(pi_c, g1_mul_fast(b_g1, r))
    pi_c = g1_add(pi_c, g1_neg(g1_mul_fast(pk.delta_g1, r * s % P)))
    return Proof(a=pi_a, b=pi_b, c=pi_c)


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    """Pairing check e(A,B) = e(alpha,beta) e(IC(x),gamma) e(C,delta) by the
    native C++ verifier; raises when the native library cannot load."""
    from .. import native
    from ..io.arkworks import serialize_proof, serialize_vkey

    if not native.available():
        raise RuntimeError("native library unavailable: "
                           "build it with `make -C native`")
    return native.groth16_verify(serialize_vkey(vk), serialize_proof(proof),
                                 [x % P for x in public_inputs])
