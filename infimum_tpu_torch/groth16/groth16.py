"""Groth16 over BN254: setup, prover and verifier, on PyTorch tensors.

Counterpart of `infimum_tpu/groth16/groth16.py`, with the same keys, the
same randomness and the same proofs:

  - setup(): the QAP by Lagrange evaluation at tau (libsnark/arkworks
    reduction with the extra public-input rows), every key element a
    fixed-base product on `device` (msm/fixed_base.py).
  - prove(): row evaluation and the H pipeline (3 iNTT + 3 coset NTT, the
    pointwise step and one coset iNTT, `ab_minus_c`) stay on `device`; the
    five MSMs (a, b1, l, h over G1 and b2 over G2) are dispatched before
    any host wait, through the CUDA MSM kernels on a card; the proof is
    assembled on the host (`prove_queries`, which groth16/zkey.py's
    prove_zkey shares). Its four stages (`h_dispatch`, `witness_limbs`,
    `msm_dispatch`, `msm_wait`) are recorded in LAST_PROVE_TRACE, with no
    sync between them.
  - verify(): the native C++ pairing (`native`), which reads the keys and
    proofs through `io.arkworks`; without the native library, verify_py's
    pure-Python pairing (curve/pairing.py).
"""

from __future__ import annotations

import os
import random
import sys
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
from ..utils.profiling import Stopwatch
from .r1cs import LC, ConstraintSystem
from .rowval import SparseRows, eval_rows, flatten_rows

P = FR_MOD
COSET_GEN = 5  # Fr's standard multiplicative generator (as arkworks)

# stage timings of the most recent prove() or prove_zkey() call
# (utils/profiling.Stopwatch as_dict), under the reference's stage names
LAST_PROVE_TRACE: dict = {}


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
        cache[key] = SparseRows(flatten_rows(rows), len(rows), device)
    return cache[key]


def ab_minus_c(abc: torch.Tensor, logm: int, g: int,
               divide_z: bool) -> torch.Tensor:
    """(m, 16) standard-form limbs from (3, m) Montgomery evaluations of
    a, b, c on the domain: one batched iNTT, one coset NTT with generator
    `g`, then a.b - c on that coset; with `divide_z`, divided by Z there
    and taken back to coefficients by a coset iNTT (h's coefficients)."""
    ev = coset_ntt(intt(abc, logm), logm, g)           # 3 transforms batched
    out = FR_CTX.sub(FR_CTX.mont_mul(ev[0], ev[1]), ev[2])
    if divide_z:
        z_inv = fr_inv((pow(g, 1 << logm, P) - 1) % P)
        out = coset_intt(FR_CTX.mont_mul(out, FR_CTX.encode(
            [z_inv], abc.device)[0]), logm, g)
    return FR_CTX.from_mont(out)


def h_rows(cs: ConstraintSystem, witness: list[int], device) -> torch.Tensor:
    """(m, 16) standard-form limbs of h's coefficients on `device`: the
    h-MSM's scalars. Row m-1 must be zero (the caller's degree gate)."""
    m = _domain_size(cs)
    abc = torch.stack(eval_rows(sparse_rows(cs, device), witness, m))
    return ab_minus_c(abc, m.bit_length() - 1, COSET_GEN, divide_z=True)


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


def _msm_inputs(pk: ProvingKey, name: str, points, scalars: torch.Tensor,
                curve: CurveDev = G1_DEV):
    """(rows, scalars, lanes) of one query's MSM on the scalars' device:
    the query's encoding, and `scalars` ((n, 16) standard-form limbs)
    padded with zeros to its rows, zero at its infinity points."""
    rows, none_mask, lanes = _query_encoding(pk, name, points, curve,
                                             scalars.device)
    n = scalars.shape[0]
    sc = torch.zeros((rows.shape[0], NLIMBS), dtype=torch.int64,
                     device=scalars.device)
    sc[:n] = torch.where(none_mask[:n].unsqueeze(-1), 0, scalars)
    return rows, sc, lanes


def _msm_async(pk: ProvingKey, name: str, points, scalars: torch.Tensor,
               curve: CurveDev = G1_DEV):
    """Dispatch one query's MSM without a host wait; `pk` is a ProvingKey
    or a ZkeyData, `scalars` (n, 16) standard-form limbs on the query's
    device. Returns a closure that waits and combines the window sums into
    the affine result."""
    rows, sc, lanes = _msm_inputs(pk, name, points, scalars, curve)
    wins = msm_rows_async(rows, sc, lanes, curve.name)
    return lambda: combine_window_points(wins.cpu(), curve.name)


def prove_queries(key, queries, h_scalars, witness: list[int], npub: int,
                  rng: random.Random | None, device) -> Proof:
    """The Groth16 prover over one key's five queries. `key` (a ProvingKey
    or a ZkeyData) holds alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2
    and the queries' cached encodings; `queries` is the (name, points) of
    its a, b1, b2 (G2), c and h queries; `h_scalars()` gives the h-MSM's
    scalars and a row that must be zero (the degree gate), or None. Draws
    r, s from `rng` first, records its stages in LAST_PROVE_TRACE."""
    global LAST_PROVE_TRACE
    sw = Stopwatch()
    rng = rng or random.SystemRandom()
    r = rng.randrange(P)
    s = rng.randrange(P)
    (a_q, b1_q, b2_q, c_q, h_q) = queries

    # No sync between the stages, as in the reference: the host waits for
    # the card only where it reads back (the degree gate, the combines).
    with sw.stage("h_dispatch"):
        h, gate = h_scalars()
    with sw.stage("witness_limbs"):
        w = ints_to_tensor([x % P for x in witness], device)
    with sw.stage("msm_dispatch"):
        a_fin = _msm_async(key, *a_q, w)
        b2_fin = _msm_async(key, *b2_q, w, G2_DEV)
        b1_fin = _msm_async(key, *b1_q, w)
        c_fin = _msm_async(key, *c_q, w[npub:])
        h_fin = _msm_async(key, *h_q, h)
    with sw.stage("msm_wait"):
        # degree gate: one row read back, queued behind the MSM dispatches
        if gate is not None and bool(gate.any()):
            raise AssertionError("h has unexpected degree")
        a_acc, b2_acc, b1_acc = a_fin(), b2_fin(), b1_fin()
        c_acc, h_acc = c_fin(), h_fin()
    LAST_PROVE_TRACE = sw.as_dict()
    if os.environ.get("INFIMUM_TRACE"):
        print(sw.report(), file=sys.stderr, flush=True)

    # A = alpha + sum + r*delta
    pi_a = g1_add(g1_add(key.alpha_g1, a_acc), g1_mul_fast(key.delta_g1, r))
    # B = beta + sum + s*delta
    pi_b = g2_add(g2_add(key.beta_g2, b2_acc), g2_mul_fast(key.delta_g2, s))
    b_g1 = g1_add(g1_add(key.beta_g1, b1_acc), g1_mul_fast(key.delta_g1, s))
    # C = L + H + s*A + r*B1 - r*s*delta
    pi_c = g1_add(c_acc, h_acc)
    pi_c = g1_add(pi_c, g1_mul_fast(pi_a, s))
    pi_c = g1_add(pi_c, g1_mul_fast(b_g1, r))
    pi_c = g1_add(pi_c, g1_neg(g1_mul_fast(key.delta_g1, r * s % P)))
    return Proof(a=pi_a, b=pi_b, c=pi_c)


def prove(pk: ProvingKey, cs: ConstraintSystem, witness: list[int],
          rng: random.Random | None = None, device="cuda") -> Proof:
    m = _domain_size(cs)

    def h_scalars():
        h = h_rows(cs, witness, device)
        return h[:m - 1], h[m - 1]

    return prove_queries(
        pk, (("a", pk.a_query), ("b1", pk.b_g1_query), ("b2", pk.b_g2_query),
             ("l", pk.l_query), ("h", pk.h_query)),
        h_scalars, witness, cs.num_public + 1, rng, device)


def prepare_inputs(vk: VerifyingKey, public_inputs: list[int]):
    """IC-combined public input point (ark-groth16 prepare_inputs)."""
    acc = vk.ic[0]
    for point, x in zip(vk.ic[1:], public_inputs):
        acc = g1_add(acc, g1_mul_fast(point, x))
    return acc


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    """Pairing check e(A,B) = e(alpha,beta) e(IC(x),gamma) e(C,delta) by the
    native C++ verifier, or by verify_py when the native library cannot
    load."""
    from .. import native

    if native.available():
        from ..io.arkworks import serialize_proof, serialize_vkey

        return native.groth16_verify(
            serialize_vkey(vk), serialize_proof(proof),
            [x % P for x in public_inputs])
    return verify_py(vk, proof, public_inputs)


def verify_py(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    """The same check on the pure-Python pairing (curve/pairing.py): about
    a second a proof."""
    from ..curve.pairing import multi_pairing_is_one

    ic = prepare_inputs(vk, public_inputs)
    # e(A, B) e(-alpha, beta) e(-IC, gamma) e(-C, delta) == 1
    return multi_pairing_is_one([
        (proof.a, proof.b),
        (g1_neg(vk.alpha_g1), vk.beta_g2),
        (g1_neg(ic), vk.gamma_g2),
        (g1_neg(proof.c), vk.delta_g2),
    ])
