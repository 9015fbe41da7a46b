"""Groth16 over BN254: setup, prover and verifier, on PyTorch tensors.

Counterpart of `infimum_tpu/groth16/groth16.py`, with the same keys, the
same randomness and the same proofs:

  - setup(): the QAP by Lagrange evaluation at tau (libsnark/arkworks
    reduction with the extra public-input rows), every key element a
    fixed-base product on `device` (msm/fixed_base.py).
  - prove(): the witness converted once to words on `device`; row
    evaluation and the H pipeline (3 iNTT + 3 coset NTT, a.b - c and one
    coset iNTT, `ab_minus_c`) on those words, through the CUDA kernels of
    csrc/fr_rows.cu and csrc/fr_ntt.cu on a card (7 launches at 2^14 and
    2^18: the rows, then a tile and a pass for each transform) and their
    plain versions on the CPU; the five MSMs
    (a, b1, l, h over G1 and b2 over G2) dispatched before any host wait,
    through the CUDA MSM kernels on a card, each recode reading the
    witness's (or h's) standard-form words as they are; the proof
    assembled on the host (`prove_queries`, which groth16/zkey.py's
    prove_zkey shares): the window sums' combine and the assembly in the
    port's native library's Jacobian arithmetic (`native.msm_combine`,
    `native.groth16_assemble`).
    Its four stages (`h_dispatch`, `witness_limbs`, `msm_dispatch`,
    `msm_wait`) are recorded in LAST_PROVE_TRACE, with no sync between
    them. `h_rows_plain` / `ab_minus_c_plain` are the H stage's plain
    version in limbs.
  - verify(): the native C++ pairing (`native`), which reads the keys and
    proofs through `io.arkworks`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from .. import native
from ..curve.bn254_host import G1_GEN, G2_GEN, g1_mul_fast, g2_mul_fast
from ..curve.proj import G1_DEV, G2_DEV, CurveDev
from ..ff.bn254 import FR_MOD, batch_inv_mod, fr_inv
from ..ff.fp import (
    FR_CTX, device_key, limbs_to_words, tensor_to_ints,
    words_to_limbs,
)
from ..msm.fixed_base import fixed_base_mul_batch
from ..msm.msm import (
    combine_window_points, encode_rows, msm_lanes, msm_rows_words,
)
from ..ntt.ntt import (
    PRODUCT, VALUE, _root_of_unity, coset_intt_plain, coset_ntt_plain,
    coset_words, fr_const, ntt_plain, ntt_words, pointwise,
)
from ..utils.profiling import (
    Stopwatch, count, print_trace, record, span, subtree,
)
from .r1cs import LC, ConstraintSystem
from .rowval import (
    SparseRows, flatten_rows, ints_to_words, rows_plain, rows_words,
)

P = FR_MOD
COSET_GEN = 5  # Fr's standard multiplicative generator (as arkworks)

# stage timings of the most recent prove() or prove_zkey() call
# (utils/profiling.Stopwatch as_dict), under the reference's stage names
LAST_PROVE_TRACE: dict = {}
# the native verifier's phases, in order (groth16.verify's spans)
VERIFY_PHASES = ("verify.checks", "verify.product", "verify.final_exp")


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
    key = device_key(device)
    if key not in cache:
        rows = _qap_rows(cs)
        cache[key] = SparseRows(flatten_rows(rows), len(rows), device)
    return cache[key]


def ab_minus_c(abc: torch.Tensor, logm: int, g: int, divide_z: bool,
               mode: int = VALUE) -> torch.Tensor:
    """(m, 8) standard-form words from (3, m, 8) Montgomery words of a, b,
    c on the domain, or, with `mode` AB, from (2, m, 8) words of a, b
    where the caller knows c = a.b (the zkey's satisfied R1CS: the first
    tile gathers a.b itself): one batched iNTT,
    one coset NTT with generator `g` (the coset powers its input table),
    then a.b - c on that coset; with `divide_z`, divided by Z there and
    taken back to coefficients by a coset iNTT (h's coefficients) that
    gathers a.b - c itself (the tile's PRODUCT mode) and whose output
    multiplies fold 1/n, 1/Z, the exit from Montgomery form and the
    inverse coset powers. On a card each step is a kernel (ntt/ntt.py): a
    tile and `pass_plan(logm)`'s passes a transform, and without
    `divide_z` one pointwise launch."""
    dev = device_key(abc.device)
    m = 1 << logm
    ev = ntt_words(ntt_words(abc, logm, True, post_c=fr_const(fr_inv(m), dev),
                             mode=mode),
                   logm, pre=coset_words(logm, g, False, dev))
    if not divide_z:
        return pointwise(ev[0], ev[1], ev[2], k=fr_const(1, dev, mont=False))
    z_inv = fr_inv((pow(g, m, P) - 1) % P)
    return ntt_words(ev, logm, True,
                     post_c=fr_const(z_inv * fr_inv(m), dev, mont=False),
                     post_t=coset_words(logm, g, True, dev), mode=PRODUCT)


def ab_minus_c_plain(abc: torch.Tensor, logm: int, g: int,
                     divide_z: bool) -> torch.Tensor:
    """Plain version of `ab_minus_c` in limbs on any device: (m, 16)
    standard-form limbs from (3, m, 16) Montgomery limbs, through the plain
    transforms (`ntt_plain`) and `ff/fp.py`'s arithmetic."""
    ev = coset_ntt_plain(ntt_plain(abc, logm, invert=True), logm, g)
    out = FR_CTX.sub(FR_CTX.mont_mul(ev[0], ev[1]), ev[2])
    if divide_z:
        z_inv = fr_inv((pow(g, 1 << logm, P) - 1) % P)
        out = coset_intt_plain(FR_CTX.mont_mul(out, FR_CTX.encode(
            [z_inv], abc.device)[0]), logm, g)
    return FR_CTX.from_mont(out)


def h_words(cs: ConstraintSystem, witness, device) -> torch.Tensor:
    """(m, 8) standard-form words of h's coefficients on `device`: the
    h-MSM's scalars as the recode reads them. Row m-1 must be zero (the
    caller's degree gate). `witness` is a list of ints or its
    standard-form words on `device` (`rowval.ints_to_words`), converted
    once a prove."""
    m = _domain_size(cs)
    if not isinstance(witness, torch.Tensor):
        witness = ints_to_words(witness, device)
    abc = rows_words(sparse_rows(cs, device), witness, m)
    return ab_minus_c(abc, m.bit_length() - 1, COSET_GEN, divide_z=True)


def h_rows(cs: ConstraintSystem, witness, device) -> torch.Tensor:
    """`h_words` as (m, 16) standard-form limbs."""
    return words_to_limbs(h_words(cs, witness, device))


def h_rows_plain(cs: ConstraintSystem, witness: list[int],
                 device) -> torch.Tensor:
    """Plain version of `h_rows` on any device: the plain row walk over
    the same rows and the standard-form witness, and `ab_minus_c_plain`."""
    m = _domain_size(cs)
    abc = words_to_limbs(rows_plain(sparse_rows(cs, device),
                                    ints_to_words(witness, device), m))
    return ab_minus_c_plain(abc, m.bit_length() - 1, COSET_GEN,
                            divide_z=True)


def compute_h(cs: ConstraintSystem, witness: list[int], device="cuda"):
    """Coefficients of h(x) = (a(x) b(x) - c(x)) / Z(x) as python ints."""
    h = tensor_to_ints(h_rows(cs, witness, device))
    m = _domain_size(cs)
    assert h[m - 1] == 0, "h has unexpected degree"
    return h[:m - 1]


# -- MSMs over cached proving-key queries -----------------------------------------

def _query_encoding(pk: ProvingKey, name: str, points, curve: CurveDev,
                    device):
    """(words, infinity mask, lanes) for a proving-key query on `device`,
    encoded once per key: words is the (N, AW) int32 table of its affine
    points that the accumulation kernel reads; an infinity point is
    replaced by the generator and given a zero scalar."""
    cache = pk.__dict__.setdefault("_torch_enc_cache", {})
    key = (name, device_key(device))
    ent = cache.get(key)
    if ent is None:
        lanes = msm_lanes(len(points), curve.name)
        none_mask = torch.tensor([p is None for p in points], dtype=torch.bool)
        safe = [curve.gen if p is None else p for p in points]
        ent = (limbs_to_words(encode_rows(safe, lanes, curve.name, device)),
               none_mask.to(device), lanes)
        cache[key] = ent
    return ent


def _msm_inputs(pk: ProvingKey, name: str, points, scalars: torch.Tensor,
                curve: CurveDev = G1_DEV):
    """(words, scalars, mask, lanes) of one query's MSM on the scalars'
    device: the query's encoded table, `scalars` as given ((n, 8)
    standard-form words, or (n, 16) limbs), and its infinity mask. No copy
    of the scalars is made: the recode reads rows n and above, and those
    the mask sets, as zero scalars."""
    words, none_mask, lanes = _query_encoding(pk, name, points, curve,
                                              scalars.device)
    return words, scalars, none_mask, lanes


def _msm_async(pk: ProvingKey, name: str, points, scalars: torch.Tensor,
               curve: CurveDev = G1_DEV):
    """Dispatch one query's MSM without a host wait; `pk` is a ProvingKey
    or a ZkeyData, `scalars` (n, 8) standard-form words (or (n, 16) limbs)
    on the query's device. Returns ((nwin, PW) window-sum words on the
    device, curve name), for `combine_window_points` once read back."""
    words, sc, mask, lanes = _msm_inputs(pk, name, points, scalars, curve)
    return msm_rows_words(words, sc, lanes, curve.name, mask=mask), curve.name


def _tail_key(key) -> bytes:
    """alpha_g1, beta_g1, delta_g1, beta_g2 and delta_g2 of a ProvingKey or
    a ZkeyData as `native.groth16_assemble` reads them, encoded once per
    key."""
    ent = key.__dict__.get("_torch_tail_key")
    if ent is None:
        ent = b"".join(native.point_bytes(p, c) for p, c in (
            (key.alpha_g1, "g1"), (key.beta_g1, "g1"), (key.delta_g1, "g1"),
            (key.beta_g2, "g2"), (key.delta_g2, "g2")))
        key.__dict__["_torch_tail_key"] = ent
    return ent


def assemble(key, a_acc, b2_acc, b1_acc, c_acc, h_acc, r: int, s: int):
    """(A, B, C) from the key, the five MSMs' points and r, s, in the
    native library's Jacobian arithmetic (`native.groth16_assemble`)."""
    return native.groth16_assemble(_tail_key(key),
                                   (a_acc, b1_acc, c_acc, h_acc, b2_acc), r, s)


def prove_queries(key, queries, h_scalars, witness: list[int], npub: int,
                  rng: random.Random | None, device) -> Proof:
    """The Groth16 prover over one key's five queries. `key` (a ProvingKey
    or a ZkeyData) holds alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2
    and the queries' cached encodings; `queries` is the (name, points) of
    its a, b1, b2 (G2), c and h queries; `h_scalars(w)` gives the h-MSM's
    scalars (standard-form words) and a row that must be zero (the degree
    gate), or None, from the witness's standard-form words on `device`.
    The witness is converted once, at the start of `h_dispatch`, and its
    words are shared by the rows and the MSMs, which read them as they
    are. Draws r, s from `rng` first, records its stages in
    LAST_PROVE_TRACE and as spans of the log (utils/profiling): `prove`
    and under it `prove.<stage>`; `prove.msm_dispatch` counts each
    query's rows under its name (`h_scalars` may count the H stage's work
    on `prove.h_dispatch`)."""
    global LAST_PROVE_TRACE
    with span("prove") as whole:
        sw = Stopwatch("prove")
        rng = rng or random.SystemRandom()
        r = rng.randrange(P)
        s = rng.randrange(P)
        (a_q, b1_q, b2_q, c_q, h_q) = queries

        # No sync between the stages, as in the reference: the host waits
        # for the card only where it reads back (the degree gate, the
        # window sums).
        with sw.stage("h_dispatch"):
            with sw.stage("words"):
                w_words = ints_to_words(witness, device)
            h, gate = h_scalars(w_words)
        with sw.stage("witness_limbs"):
            # the MSMs read the witness's words as they are (the recode
            # pads and masks them): the stage keeps its name, and holds
            # the c query's slice of them
            w_c = w_words[npub:]
        with sw.stage("msm_dispatch",
                      **{name: len(points) for name, points in queries}):
            sums = [_msm_async(key, *a_q, w_words),
                    _msm_async(key, *b2_q, w_words, G2_DEV),
                    _msm_async(key, *b1_q, w_words),
                    _msm_async(key, *c_q, w_c),
                    _msm_async(key, *h_q, h)]
        with sw.stage("msm_wait"):
            # the first read-back, queued behind every MSM dispatch, waits
            # for the card: the degree gate's row, else the first sums
            with sw.stage("card"):
                if gate is not None:
                    if bool(gate.any()):
                        raise AssertionError("h has unexpected degree")
                    host = []
                else:
                    host = [sums[0][0].cpu()]
            with sw.stage("combine"):
                host += [wins.cpu() for wins, _ in sums[len(host):]]
                a_acc, b2_acc, b1_acc, c_acc, h_acc = [
                    combine_window_points(wins, curve)
                    for wins, (_, curve) in zip(host, sums)]
        LAST_PROVE_TRACE = sw.as_dict()

        with sw.stage("assembly"):
            pi_a, pi_b, pi_c = assemble(key, a_acc, b2_acc, b1_acc, c_acc,
                                        h_acc, r, s)
    print_trace(subtree(whole))
    return Proof(a=pi_a, b=pi_b, c=pi_c)


def prove(pk: ProvingKey, cs: ConstraintSystem, witness: list[int],
          rng: random.Random | None = None, device="cuda") -> Proof:
    m = _domain_size(cs)

    def h_scalars(w_words):
        h = h_words(cs, w_words, device)
        # the H stage's work: its domain and the row table's terms over a,
        # b and c (the public rows' included)
        count(domain=m, terms=sparse_rows(cs, device).nnz)
        return h[:m - 1], h[m - 1]

    return prove_queries(
        pk, (("a", pk.a_query), ("b1", pk.b_g1_query), ("b2", pk.b_g2_query),
             ("l", pk.l_query), ("h", pk.h_query)),
        h_scalars, witness, cs.num_public + 1, rng, device)


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    """Pairing check e(A,B) = e(alpha,beta) e(IC(x),gamma) e(C,delta) by the
    native C++ verifier. Spans: `verify`, and under it `verify.encode` (the
    key, proof and public inputs to bytes) and the native call's phases as
    it timed them, `verify.checks` (every point read and checked on its
    curve and subgroup, the public inputs' range), `verify.product` (the
    public inputs' IC combination and one multi-Miller loop over the four
    pairs) and `verify.final_exp`; a malformed input has only the phases
    that ran."""
    with span("verify"):
        from ..io.arkworks import serialize_proof, serialize_vkey

        with span("verify.encode") as enc:
            vk_bytes, proof_bytes = serialize_vkey(vk), serialize_proof(proof)
            publics = [x % P for x in public_inputs]
        try:
            return native.groth16_verify(vk_bytes, proof_bytes, publics)
        finally:
            marks = native.verify_last_phases()
            if marks[0] >= enc.end:     # this call's, not an earlier one's
                for name, a, b in zip(VERIFY_PHASES, marks, marks[1:]):
                    if b:
                        record(name, a, b)

