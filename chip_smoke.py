"""Smoke run of infimum_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
  1. probe: torch / CUDA versions, the card, compute capability 9.0;
  2. build: the CUDA kernels from infimum_tpu_torch/csrc/ (nvcc, sm_90a);
  3. e2e: the reference-dims poll, ProcessMessages(10,2,1,2) and
     TallyVotes(10,1,2): keys through the key cache (setup on the card on
     a miss), the prewarm (kernels, hint programs, a throwaway proof per
     circuit), the poll lifecycle through the port's pallet and user
     roles, all six batches proved through infimum_tpu_torch, each
     self-verified by the native pairing (timed apart from its prove, as
     the reference e2e times it), then `commit_outcome` checks every proof
     against the pallet's own public inputs, outcome option 5; the last
     process and tally prove()'s stage traces, the prewarm and the kernel
     load log printed; then the process key loaded again from the cache
     (a hit: setup is not run), its load time beside the setup's, and a
     proof from the loaded key verified;
  4. kernels at the first process proof's shapes: at each of its five
     MSMs (`a`, `b1`, `l`, `h` over G1, `b2` over G2) the layout stage and
     the accumulation kernel timed, with the mixed adds, the bound, the
     kernel's registers and its grid in waves; at `a` and `b2` each MSM
     kernel held against its plain torch version (equal emitted digits and
     limbs, equal window points as affine points) and timed; the weighted
     kernel's grid (at least one block per SM) and the adds its chunks cost
     beside the bound's; then the median of three steady `prove()` calls
     of the first process batch with their stage traces, and the H
     pipeline's host enqueue time beside its span on the card;
  5. negative checks: a tampered proof and a wrong public input are
     rejected;
  6. path checks: every MSM kernel was launched in the e2e run, and no
     module of JAX or of the JAX package `infimum_tpu` was imported;
  7. Poseidon on the card: (a) the largest legal poll's trees, 1,022
     sign-up leaves in the binary depth-10 registration tree and 15,624
     message leaves in the quinary depth-6 message tree, every leaf batch
     hashed by the Poseidon kernel and both trees built level by level
     through it, leaves and roots equal to the native library's and every
     launch's permuted state equal to the plain version's, each launch
     timed; (b) 2^16 states at t = 3 and 5 (the trees' widths) and 6 (the
     benchmark's width-5 hashes), kernel equal to its plain version (and
     at t = 6 to the native library), timed beside its bound; (c) every
     width t = 2..13 at 1,000 states against the native library; (d) the
     kernel's four variants at t = 6 timed in turns; (e) its registers
     and stack per width; then the same path checks for the Poseidon
     kernel in (a);
  8. the largest legal poll (`client/scale.py` `run_scale_poll` at its
     defaults: 1,022 sign-ups, 15,624 messages, ProcessMessages(10,6,1,2)
     and TallyVotes(10,1,2), 8 + 4 sampled proofs) on the card, its whole
     record printed: every one of the 3,125 + 512 commitments walks
     through the pallet poll's `prepare_public_inputs` (counted here),
     every sampled proof verifies by the native pairing (counted here),
     all four MSM kernel instances launch in the phase; then each MSM
     kernel held against its plain version at the first sampled process
     proof's shapes, and the same path checks;
  9. the zkey path at reference dims (ProcessMessages(10,2,1,2), domain
     2^18): `generate_zkey` on the card, `write_zkey` to a file and
     `read_zkey` back, every field equal, the file's size and each step's
     seconds; `prove_zkey` of phase 3's first process witness twice from
     the read zkey (the first encodes the queries, the second is steady),
     each proof verified by the native pairing under `vk_from_zkey` and
     through the arkworks bytes, a tampered proof and a wrong public input
     rejected, all four MSM kernel instances launched; three steady
     `prove()` and `prove_zkey` calls of that witness in turns, each with
     its stage trace; each MSM kernel held against its plain version at
     the zkey's `h` shape (2^18 rows);
 10. the parallel witness: `PollProver.prove_poll_results` of the e2e's
     poll with forked witness workers (INFIMUM_PARALLEL_WITNESS=1) and on
     its default thread, each from a fresh prover with the e2e's seed, the
     batches equal byte for byte, no batch fallen back to the parent
     within a 120 s timeout, both wall times and the worker count printed.
The last three lines of standard output are a JSON line with each kernel's
launches, error, times and bound, then the card's name and power limit;
the very last line is the result: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as tnf

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_ROWS = (
    ("msm_accum_g1", "infimum_tpu_torch/csrc/msm_accum.cu",
     "infimum_tpu/msm/pallas_msm.py:211"),
    ("msm_accum_g2", "infimum_tpu_torch/csrc/msm_accum.cu",
     "infimum_tpu/msm/pallas_msm.py:211"),
    ("msm_weighted_g1", "infimum_tpu_torch/csrc/msm_weighted.cu",
     "infimum_tpu/msm/pallas_msm.py:380"),
    ("msm_weighted_g2", "infimum_tpu_torch/csrc/msm_weighted.cu",
     "infimum_tpu/msm/pallas_msm.py:380"),
    ("poseidon_perm", "infimum_tpu_torch/csrc/poseidon_perm.cu",
     "infimum_tpu/hash/poseidon_pallas.py:236"),
)
# Bounds: the larger of bytes over the memory rate and 32-bit multiplies
# over their rate. HBM3 of an H100 SXM: 3.35 TB/s (NVIDIA's data sheet).
# 32-bit integer multiply and multiply-add: 64 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of arithmetic
# instructions), times the SM count and the card's maximum SM clock. A
# Montgomery product (CIOS over 8 words) takes 8 x (8 + 1 + 8) products,
# each low and high half: 264 multiplies.
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_CLOCK_SM = 64
MULS_PER_MONT = 264
# Fq products per complete add (RCB Alg. 7) and per mixed add (Alg. 8): an
# Fq2 product is 3 Fq products, and so is the G2 3b product (one Fq2
# product by the constant, Fq2OutOfLine::b3); the G1 3b product is
# additions.
ADD_MULS = {"g1": 12, "g2": 12 * 3 + 2 * 3}
MIXED_MULS = {"g1": 11, "g2": 11 * 3 + 2 * 3}
SIGNUPS, MESSAGES = 1022, 15624   # client/scale.py: the largest legal poll
POLL_SEED, BENCH_SEED = 20260820, 20260819
ZKEY_SEED = 20260821
WITNESS_TIMEOUT_S = 120


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_line() -> str:
    return smi("name,power.limit")


def int32_mul_rate() -> float:
    """32-bit integer multiplies per second of the card at its maximum SM
    clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_MULS_PER_CLOCK_SM * mhz * 1e6


def bound(nbytes: float, mont_muls: float, mul_rate: float):
    """(least ms, "bytes" or "operations") for the given work."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = mont_muls * MULS_PER_MONT / mul_rate * 1e3
    return (by_bytes, "bytes") if by_bytes > by_ops else (by_ops,
                                                          "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int, warm: int = 0):
    """(mean milliseconds of fn() over `reps` runs by CUDA events after
    `warm` untimed runs, the last run's result)."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def query_inputs(pk, cs, witness):
    """The five MSMs of one process proof as `prove()` dispatches them:
    (name, curve, rows, scalars, lanes) for `a`, `b1`, `l`, `h` (G1) and
    `b2` (G2)."""
    from infimum_tpu_torch.curve.proj import G1_DEV, G2_DEV
    from infimum_tpu_torch.ff.bn254 import FR_MOD
    from infimum_tpu_torch.ff.fp import ints_to_tensor
    from infimum_tpu_torch.groth16.groth16 import (
        _domain_size, _msm_inputs, h_rows,
    )

    w = ints_to_tensor([x % FR_MOD for x in witness], "cuda")
    npub, m = cs.num_public + 1, _domain_size(cs)
    return [(name, curve, *_msm_inputs(pk, name, points, scalars, curve))
            for name, points, curve, scalars in (
                ("a", pk.a_query, G1_DEV, w), ("b1", pk.b_g1_query, G1_DEV, w),
                ("l", pk.l_query, G1_DEV, w[npub:]),
                ("h", pk.h_query, G1_DEV,
                 h_rows(cs, witness, "cuda")[:m - 1]),
                ("b2", pk.b_g2_query, G2_DEV, w))]


RESOURCES = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
    r"spill stores, (\d+) bytes spill loads(?:\nptxas info\s*: Used (\d+) "
    r"registers)?")


def accum_resources(curve: str) -> str:
    """The accumulation kernel's registers and spills for `curve` from
    nvcc's --resource-usage report of this run's build."""
    from infimum_tpu_torch import kernels

    tag = "12Fq2OutOfLine" if curve == "g2" else "11FqOutOfLine"
    for m in RESOURCES.finditer(kernels.BUILD_INFO.get("log", "")):
        if "msm_accum_kernel" in m.group(1) and tag in m.group(1):
            return (f"{m.group(5)} registers, {m.group(2)} B stack, "
                    f"{m.group(3)} B spill stores, {m.group(4)} B spill loads")
    return "registers not in this run's build log"


def accum_grid(sdig, lanes: int, curve: str):
    """(blocks, blocks with a live lane, resident blocks) of the
    accumulation kernel's grid: one warp of lanes a block."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.msm import msm as M

    block, per_sm = kernels.accum_occupancy(curve)
    nwin = sdig.shape[0]
    nlb = -(-lanes // block)
    lane_live = sdig[..., -1] > 0              # a lane's last digit is its top
    live = tnf.pad(lane_live, (0, nlb * block - lanes)).view(
        nwin, nlb, block).any(-1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return nlb * nwin, int(live.sum()), per_sm * sms


def kernel_vs_plain(pk, cs, witness, mul_rate, tag=""):
    """Time the accumulation kernel and the layout before it at the five
    MSM shapes of a process proof; at `a` (G1) and `b2` (G2) also compare
    each MSM kernel with its plain version. Returns per-kernel rows
    (error, ms, plain ms, bound ms, bound by) at `a` and `b2`. `tag` goes
    before each line's label."""
    rows_out = {}
    for name, curve, rows, sc, lanes in query_inputs(pk, cs, witness):
        rows_out.update(msm_kernels(name, curve, rows, sc, lanes, mul_rate,
                                    tag, compare=name in ("a", "b2")))
    return rows_out


def msm_kernels(name, curve, rows, sc, lanes, mul_rate, tag="",
                compare=False) -> dict:
    """One MSM's layout stage and accumulation kernel timed, with the
    mixed adds, the bound, the kernel's registers and its grid in waves;
    with `compare`, each MSM kernel held against its plain torch version
    (equal emitted digits and limbs, equal window points as affine points)
    and timed. Returns per-kernel rows (error, ms, plain ms, bound ms,
    bound by) when it compares, else nothing."""
    from infimum_tpu_torch.msm import msm as M

    spec = M.SPECS[curve.name]
    N = rows.shape[0]
    lay_ms, layout = cuda_ms(
        lambda: M.lane_layout(rows, sc, lanes, spec), 3, warm=1)
    acc_ms, (edig, ept) = cuda_ms(lambda: M.accumulate(*layout, spec), 3,
                                  warm=1)
    # the least work these inputs need: one mixed add per entry whose
    # digit repeats the one before it in its lane (and is not 0)
    sdig = layout[0]
    mixed = int(((sdig[..., 1:] == sdig[..., :-1]) & (sdig[..., 1:] != 0))
                .sum())
    acc_bound = bound(nbytes(*layout, edig, ept),
                      mixed * MIXED_MULS[curve.name], mul_rate)
    blocks, live, resident = accum_grid(sdig, lanes, curve.name)
    log(f"[{tag}accum] {name} ({curve.name}, {N} rows, {lanes} lanes, T "
        f"{N // lanes}): layout {lay_ms:.3f} ms; kernel {acc_ms:.3f} ms;"
        f" {mixed} mixed adds, bound {acc_bound[0]:.3f} ms "
        f"({acc_bound[1]}), {acc_bound[0] / acc_ms:.1%} of bound; "
        f"{accum_resources(curve.name)}; grid {blocks} blocks, {live} "
        f"with a live lane, {resident} resident = "
        f"{blocks / resident:.2f} waves ({live / resident:.2f} live)")
    if not compare:
        return {}
    acc_plain_ms, plain_e = cuda_ms(
        lambda: M.accumulate_plain(*layout, spec), 1)
    K = spec.n_buckets + lanes + 2
    cdig, cpts = M.compact(edig, ept, K)
    pdig, ppts = M.compact(*plain_e, K)
    if not torch.equal(cdig, pdig):
        raise AssertionError(f"{name}: emitted digits differ")
    if not torch.equal(cpts, ppts):
        raise AssertionError(f"{name}: emitted points differ")
    wt_ms, wk = cuda_ms(lambda: M.weighted_sum(cdig, cpts, spec), 3)
    wt_plain_ms, wp = cuda_ms(
        lambda: M.weighted_sum_plain(pdig, ppts, spec), 1)
    got = M.decode_windows(M.words_to_limbs(wk).cpu(), curve.name)
    want = M.decode_windows(M.words_to_limbs(wp).cpu(), curve.name)
    err = max(_affine_err(g, p) for g, p in zip(got, want))
    log(f"[{tag}kernel_vs_plain] {name} ({curve.name}): accum {acc_ms:.3f} ms"
        f" vs plain {acc_plain_ms:.3f} ms, emissions equal (digits and "
        f"limbs); weighted {wt_ms:.3f} ms vs plain {wt_plain_ms:.3f} ms;"
        f" window points equal: {got == want}")
    if got != want:
        raise AssertionError(f"{name}: kernel and plain windows differ")
    # per window, with a running sum (the slots of a digit summed into
    # its bucket, then from the largest digit D down the running bucket
    # sum added into the total once a digit): live slots + D - 2
    # complete adds
    live_slots = (cdig > 0).sum(1)
    top = cdig.max(1).values.to(torch.int64)
    adds = int(torch.where(live_slots > 0, live_slots + top - 2, 0).sum())
    wt_bound = bound(nbytes(cdig, cpts, wk),
                     adds * ADD_MULS[curve.name], mul_rate)
    log(f"[{tag}bound] {name}: {int(live_slots.sum())} live slots, {adds} "
        f"complete adds -> weighted bound {wt_bound[0]:.4f} ms "
        f"({wt_bound[1]})")
    weighted_grid(name, spec, cdig, adds, tag)
    return {f"msm_accum_{curve.name}": (err, acc_ms, acc_plain_ms,
                                        *acc_bound),
            f"msm_weighted_{curve.name}": (err, wt_ms, wt_plain_ms,
                                           *wt_bound)}


def weighted_adds(cdig, spec) -> dict:
    """The complete adds the weighted kernel's chunk walks do on `cdig`
    ("chunks"), counting each lane alone, and the adds that sum the live
    chunks' values per window ("sums"). A gap g of the walk costs
    bitlen(g) + popcount(g) - 1 adds (double-and-add); the multiple by the
    chunk's smallest digit, in 2-bit windows, 2 for the table, 2 per window
    below the top one and 1 per nonzero one, and 1 to add it in."""
    from infimum_tpu_torch.msm import msm as M

    d = M._chunk_digits(cdig, spec.chunk)
    if d is None:
        return {"chunks": 0, "sums": 0}
    lv = d > 0
    gaps = torch.where(lv[..., 1:], d[..., 1:] - d[..., :-1], 0)
    first = d[..., 0]
    bits = torch.zeros_like(gaps)
    ones = torch.zeros_like(gaps)
    for b in range(spec.c_bits + 1):
        bit = (gaps >> b) & 1
        ones += bit
        bits = torch.where(bit == 1, b + 1, bits)
    walk = torch.where(gaps > 0, bits + ones - 1, 0)
    top = torch.zeros_like(first)             # index of the top 2-bit window
    nonzero = torch.zeros_like(first)         # nonzero windows, top included
    for i in range(spec.c_bits // 2 + 1):
        win = (first >> (2 * i)) & 3
        nonzero += (win > 0).to(first.dtype)
        top = torch.where(win > 0, i, top)
    final = torch.where(first > 0, 2 + 2 * top + nonzero, 0)
    n_live = lv.sum(-1)
    live_chunks = (n_live > 0).sum(-1)
    return {"chunks": int((n_live - 1).clamp(min=0).sum() + walk.sum()
                          + final.sum()),
            "sums": int((live_chunks - 1).clamp(min=0).sum())}


def weighted_grid(name, spec, cdig, bound_adds, tag="") -> None:
    """The weighted kernel's grid and the adds its chunk walks cost beside
    the bound's. Fails when the grid has fewer blocks than the card has
    SMs."""
    from infimum_tpu_torch.msm import msm as M

    nwin, K = cdig.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = M.weighted_blocks(K, spec) * nwin
    cost = weighted_adds(cdig, spec)
    log(f"[{tag}weighted] {name} chunk {spec.chunk}: grid {blocks} blocks of "
        f"{M.CHUNKS_PER_BLOCK} threads; chunk walks {cost['chunks']} complete"
        f" adds + {cost['sums']} to sum the chunks = "
        f"{(cost['chunks'] + cost['sums']) / bound_adds:.2f} x the bound's "
        f"{bound_adds}")
    if blocks < sms:
        raise AssertionError(f"{name}: {blocks} blocks on {sms} SMs")


def steady_prove(pk, cs, witness, publics) -> float:
    """Median of three `prove()` calls of one batch by the CUDA-synchronised
    host clock, in ms, each with its stage trace; the last proof must
    verify. Then the H pipeline alone, three times: the host's time to
    enqueue it beside the card's span by CUDA events."""
    from infimum_tpu_torch.groth16 import groth16 as g16

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = g16.prove(pk, cs, witness, device="cuda")
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3, g16.LAST_PROVE_TRACE))
    if not g16.verify(pk.vk, proof, publics):
        raise AssertionError("steady proof rejected")
    runs.sort(key=lambda r: r[0])
    log(f"[prove] steady process prove(): median {runs[1][0]:.1f} ms of "
        f"{', '.join(f'{t:.1f}' for t, _ in runs)} (proof verifies); each "
        f"run's stage trace (s): {'; '.join(json.dumps(tr) for _, tr in runs)}"
        f"; card {card_line()}")
    # the H pipeline alone: the host's time to enqueue it against the
    # card's span from its first launch to its last
    spans = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        g16.h_rows(cs, witness, "cuda")
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spans.append(f"host {host_ms:.1f} / card {start.elapsed_time(end):.1f}")
    log(f"[prove] H pipeline (h_rows) ms, host enqueue / card span: "
        f"{'; '.join(spans)}")
    return runs[1][0]


def _affine_err(p, q) -> int:
    """Largest absolute coordinate difference of two affine points."""
    if p is None or q is None:
        return 0 if p is q else 1 << 256

    def flat(pt):
        return [c for v in pt for c in (v if isinstance(v, tuple) else (v,))]
    return max(abs(a - b) for a, b in zip(flat(p), flat(q)))


def _equal(name: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: kernel result differs from native")


def _state_err(got, want) -> int:
    """Largest absolute difference of the field elements of two Montgomery
    limb states (..., 16)."""
    from infimum_tpu_torch.ff.fp import FR_CTX

    return max(abs(a - b) for a, b in zip(FR_CTX.decode(got),
                                           FR_CTX.decode(want)))


def poll_trees(native):
    """Phase 7(a): the largest legal poll's leaves and trees through the
    kernel, held against the native library, and every launch's state held
    against the plain version. Returns (the kernel's launches in this phase,
    largest error against plain)."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.ff.bn254 import FR_MOD
    from infimum_tpu_torch.ff.fp import words_to_limbs
    from infimum_tpu_torch.hash import poseidon as H
    from infimum_tpu_torch.parallel.tree import tree_root
    from infimum_tpu_torch.tree.zeros import merkle_zeros

    rng = random.Random(POLL_SEED)
    signups = [[rng.randrange(FR_MOD), rng.randrange(FR_MOD), 1, 2 + i]
               for i in range(SIGNUPS)]
    messages = [[rng.randrange(FR_MOD) for _ in range(12)]
                for _ in range(MESSAGES)]        # data[0..10], pkx, pky
    zeros2, zeros5 = merkle_zeros(2)[0], merkle_zeros(5)[0]

    launched = []      # (input, output, start, end) of each kernel launch
    real_perm = H.perm_words

    def recording_perm(words):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_perm(words)
        end.record()
        launched.append((words, out, start, end))
        return out

    H.perm_words = recording_perm
    try:
        kernels.reset_counts()
        t0 = time.perf_counter()
        signup_leaves = H.poseidon_batch([list(c) for c in zip(*signups)])
        cols = list(zip(*messages))
        left = H.poseidon_batch([list(c) for c in cols[:5]])
        right = H.poseidon_batch([list(c) for c in cols[5:10]])
        msg_leaves = H.poseidon_batch([left, right, list(cols[10]),
                                       list(cols[11])])
        t1 = time.perf_counter()
        reg_root = tree_root(2, 10, [zeros2] + signup_leaves, zero=zeros2)
        msg_root = tree_root(5, 6, msg_leaves, zero=zeros5)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = kernels.launch_counts()["poseidon_perm"]
    finally:
        H.perm_words = real_perm

    n_signup = native.poseidon_batch(signups, 4)
    n_left = native.poseidon_batch([m[:5] for m in messages], 5)
    n_right = native.poseidon_batch([m[5:10] for m in messages], 5)
    n_msg = native.poseidon_batch(
        [[a, b, m[10], m[11]] for a, b, m in zip(n_left, n_right, messages)],
        4)
    t3 = time.perf_counter()
    reg = native.NativeIMT(2, 10, zero_seed=True)
    for leaf in n_signup:
        reg.insert(leaf)
    reg.merge(True)
    msg = native.NativeIMT(5, 6, zero_seed=False)
    for leaf in n_msg:
        msg.insert(leaf)
    msg.merge(True)
    t4 = time.perf_counter()
    _equal("sign-up leaves", signup_leaves, n_signup)
    _equal("message halves", (left, right), (n_left, n_right))
    _equal("message leaves", msg_leaves, n_msg)
    _equal("registration root", reg_root, reg.root)
    _equal("message root", msg_root, msg.root)
    if len(launched) != launches:
        raise AssertionError(f"{len(launched)} launches recorded, "
                             f"{launches} counted")
    err, shapes = 0, []
    for words, out, start, end in launched:
        state = words_to_limbs(words.transpose(1, 2))
        kernel = words_to_limbs(out.transpose(1, 2))
        plain = H.poseidon_perm_plain(state)
        if not torch.equal(kernel, plain):
            raise AssertionError(f"poseidon_perm: kernel and plain differ at "
                                 f"{tuple(words.shape)}")
        err = max(err, _state_err(kernel, plain))
        shapes.append(f"{words.shape[0]}x{words.shape[2]} "
                      f"{start.elapsed_time(end):.4f} ms")
    log(f"[poseidon] poll trees: {SIGNUPS} sign-up + {3 * MESSAGES} message "
        f"hashes {t1 - t0:.3f}s, registration (2, 10) + message (5, 6) trees "
        f"{t2 - t1:.3f}s on the card, {launches} kernel launches; native "
        f"library on the host: hashes {t3 - t2:.3f}s, IMT inserts + merges "
        f"{t4 - t3:.3f}s; leaves and both roots equal native; every "
        f"launch's state equals the plain version, max abs err {err}; each "
        f"launch's t x B and CUDA-event time: {', '.join(shapes)}")
    return launches, err


def perm_bound(t: int, b: int, words, out, mul_rate):
    """(bound ms, bound by, Fr products a state, bound ms by those
    products) of `b` permutations of width t. The least work is the sparse
    form of the Poseidon paper's App. B (circomlib's poseidon.circom), 3
    products per S-box; a full round t S-boxes and a dense t x t product, a
    partial round one S-box and a sparse product (first row and first
    column, 2t - 1); the dense pre-matrix takes the place of the MDS in the
    fourth round. Its 32-bit multiplies: a matrix row's t products summed
    with one Montgomery reduction (128 t + 136, as the kernel sums them),
    every other product 264. The bytes are the states in and out and the
    kernel's tables."""
    from infimum_tpu_torch.hash import poseidon as H
    from infimum_tpu_torch.hash.grain import FULL_ROUNDS, PARTIAL_ROUNDS

    r_p = PARTIAL_ROUNDS[t - 2]
    rounds_muls = FULL_ROUNDS * (3 * t + t * t) + r_p * (3 + 2 * t - 1)
    sums = FULL_ROUNDS * t + r_p
    muls = (sums * (128 * t + 136)
            + (rounds_muls - sums * t) * MULS_PER_MONT)
    moved = nbytes(words, out, *H.tables(t, "cuda", words=True))
    least = bound(moved, b * muls / MULS_PER_MONT, mul_rate)
    return (*least, rounds_muls, bound(moved, b * rounds_muls, mul_rate)[0])


def bench_batch(native, mul_rate):
    """Phase 7(b): 2^16 permutations at t = 3, 5 (the trees' widths) and 6
    (the benchmark's width-5 hashes), each kernel vs plain and timed beside
    its bound, t = 6 also vs native; returns t = 6's (error, ms, plain ms,
    bound ms, bound by)."""
    from infimum_tpu_torch.ff.bn254 import FR_MOD
    from infimum_tpu_torch.ff.fp import FR_CTX, limbs_to_words
    from infimum_tpu_torch.hash import poseidon as H

    b = 1 << 16
    rng = random.Random(BENCH_SEED)
    for t in (3, 5, 6):
        cols = [[rng.randrange(FR_MOD) for _ in range(b)]
                for _ in range(t - 1)]
        state = torch.cat([torch.zeros((1, b, 16), dtype=torch.int64,
                                       device="cuda"),
                           torch.stack([FR_CTX.encode(c, "cuda")
                                        for c in cols])])
        words = limbs_to_words(state).transpose(1, 2).contiguous()
        ms, out_words = cuda_ms(lambda: H.perm_words(words), 10, warm=1)
        plain_ms, plain = cuda_ms(lambda: H.poseidon_perm_plain(state), 1)
        kernel = H.poseidon_perm(state)
        if not torch.equal(kernel, plain):
            raise AssertionError(f"poseidon_perm: kernel and plain differ at "
                                 f"t = {t}")
        err = _state_err(kernel, plain)
        bnd_ms, bnd_by, muls, prod_ms = perm_bound(t, b, words, out_words,
                                                   mul_rate)
        if t == 6:
            _equal("2^16 w5 batch", FR_CTX.decode(kernel[0]),
                   native.poseidon_batch([list(r) for r in zip(*cols)],
                                         t - 1))
        log(f"[poseidon] 2^16 states, t = {t}: kernel {ms:.4f} ms "
            f"({b / ms * 1e3:.1f} permutations/s), plain {plain_ms:.3f} ms,"
            f" bound {bnd_ms:.4f} ms ({bnd_by}; {muls} Fr products a "
            f"state, each row's sum reduced once), {bnd_ms / ms:.1%} of "
            f"bound; {prod_ms:.4f} ms at 264 multiplies a product, "
            f"{prod_ms / ms:.1%} of it; kernel == plain on all "
            f"{b} lanes (max abs err {err})"
            + (", == native" if t == 6 else "") + f"; card {card_line()}")
        if t == 6:
            row = (err, ms, plain_ms, bnd_ms, bnd_by)
            perm_variants(words, out_words)
    return row


def perm_variants(words, want) -> None:
    """Phase 7(d): the kernel's variants at t = 6 (product inlined or out
    of line, tables through __ldg or in shared memory, and each matrix row
    summed as t reduced products) on the same 2^16 states, in turns, each
    equal to the main instance."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.hash import poseidon as H

    times = {name: [] for name in H.VARIANTS}
    for name in [*H.VARIANTS, *reversed(H.VARIANTS)]:
        ms, out = cuda_ms(lambda: H.perm_words(words, H.VARIANTS[name]), 10,
                          warm=1)
        if not torch.equal(out, want):
            raise AssertionError(f"poseidon_perm variant {name} differs")
        times[name].append(ms)
    main = kernels.perm_main_variant()
    log("[poseidon] variants at 2^16 states, t = 6 (ms, in turns; all "
        "equal the main instance): " + "; ".join(
            f"{name}{' (main)' if H.VARIANTS[name] == main else ''} "
            + " / ".join(f"{ms:.4f}" for ms in ts)
            for name, ts in times.items()))


def perm_resources() -> None:
    """Phase 7(e): the Poseidon kernel's registers and stack per width and
    variant, and the out-of-line product's frame, from nvcc's
    --resource-usage report of this run's build."""
    from infimum_tpu_torch import kernels

    main = kernels.perm_main_variant()
    found = {}                      # label -> (sort key, text)
    for m in RESOURCES.finditer(kernels.BUILD_INFO.get("log", "")):
        name = m.group(1)
        width = re.search(r"poseidon_perm_kernelILi(\d+)E", name)
        if width:
            smem, sums = re.search(r"Lb([01])ELb([01])E", name).groups()
            variant = (("FrOutOfLine" in name) | (smem == "1") << 1
                       | (sums == "0") << 2)
            label = f"t = {width.group(1)}" + (
                "" if variant == main else f" variant {variant}")
            found[label] = ((int(width.group(1)), variant != main, variant),
                            f"{m.group(5)} registers, {m.group(2)} B stack, "
                            f"{m.group(3)}/{m.group(4)} B spill stores/loads")
        elif "FrOutOfLine" in name:
            found["FrOutOfLine::mul"] = (
                (0, False, 0), f"{m.group(2)} B stack, {m.group(3)}/"
                f"{m.group(4)} B spill stores/loads")
    if not found:
        log("[poseidon] registers: not in this run's build log (cached)")
        return
    log(f"[poseidon] resources (main instance = variant {main}): " + "; ".join(
        f"{label}: {text}" for label, (_, text) in sorted(
            found.items(), key=lambda kv: kv[1][0])))


def width_sweep(native) -> None:
    """Phase 7(c): every width t = 2..13 at 1,000 states vs native."""
    from infimum_tpu_torch.ff.bn254 import FR_MOD
    from infimum_tpu_torch.hash.poseidon import poseidon_batch

    rng = random.Random(POLL_SEED + 1)
    for t in range(2, 14):
        cols = [[rng.randrange(FR_MOD) for _ in range(1000)]
                for _ in range(t - 1)]
        _equal(f"width {t}", poseidon_batch(cols), native.poseidon_batch(
            [list(r) for r in zip(*cols)], t - 1))
    log("[poseidon] widths t = 2..13 at 1,000 states equal native")


def batch_times(timings: dict) -> None:
    """Phase 3: every batch is timed as a prove and, apart, a self-verify,
    as the reference e2e times them; prints both."""
    proves = sorted(k for k in timings if k.startswith("prove_"))
    if len(proves) != 6:
        raise AssertionError(f"want 6 prove_* timings, got {proves}")
    for k in proves:
        v = "selfverify_" + k[len("prove_"):]
        if v not in timings:
            raise AssertionError(f"{k} has no {v}")
        log(f"[e2e] {k[len('prove_'):]}: prove {timings[k]:.3f}s, "
            f"self-verify {timings[v]:.3f}s")
    log(f"[e2e] proof_latency_s {timings['proof_latency_s']} (witness "
        f"inputs, witnesses and proves, no self-verify)")


STAGES = ["h_dispatch", "witness_limbs", "msm_dispatch", "msm_wait"]


def e2e_records(timings: dict) -> None:
    """Phase 3: the stage traces of the last process and tally prove(),
    the prewarm and the kernel load log; each trace has the four stages."""
    for kind in ("process", "tally"):
        trace = timings[f"trace_{kind}"]
        if list(trace) != STAGES:
            raise AssertionError(f"trace_{kind} has stages {list(trace)}")
        log(f"[e2e] trace_{kind} (s, host clock, no sync between stages): "
            f"{json.dumps(trace)}")
    log(f"[e2e] prewarm {timings['prewarm']}s; kernel_load_log "
        f"{json.dumps(timings['kernel_load_log'])}")
    if len(timings["kernel_load_log"]) != 3:
        raise AssertionError("kernel_load_log wants one entry a source")


def cache_hit(run, cache_before: set, seed: int = 99) -> None:
    """Phase 3: `setup_cached` for the process circuit with the e2e's seed
    must load the key the e2e cached (setup is not run), and a proof from
    the loaded key must verify."""
    from infimum_tpu_torch.groth16 import groth16 as g16, pkcache

    written = sorted(set(os.listdir(pkcache.default_cache_dir()))
                     - cache_before)
    real_setup = pkcache.setup

    def no_setup(*a, **k):
        raise AssertionError("setup_cached missed the key cache")

    pkcache.setup = no_setup
    try:
        t0 = time.perf_counter()
        pk = pkcache.setup_cached(run.keys.process_circuit.cs,
                                  random.Random(seed), label="process",
                                  device="cuda")
        load_s = time.perf_counter() - t0
    finally:
        pkcache.setup = real_setup
    if pk.vk != run.keys.process_pk.vk:
        raise AssertionError("the loaded key's vk differs")
    first = run.first_process
    proof = g16.prove(pk, run.keys.process_circuit.cs, first["witness"],
                      rng=random.Random(1), device="cuda")
    if not g16.verify(pk.vk, proof, first["publics"]):
        raise AssertionError("a proof from the loaded key was rejected")
    log(f"[pkcache] process key loaded from the cache in {load_s:.3f}s, "
        f"against setup_process {run.timings['setup_process']}s in the e2e "
        f"({'a miss: it wrote ' + ', '.join(written) if written else 'a hit too'}"
        f"); a proof from the loaded key verifies; card {card_line()}")


def scale_poll(mul_rate) -> None:
    """Phase 8: the largest legal poll on the card; counts the commitments
    walked through the pallet poll and the native verifications, checks
    that all four MSM kernel instances launched, then holds the MSM
    kernels against their plain versions at the first sampled process
    proof's shapes."""
    from infimum_tpu_torch import kernels, native
    from infimum_tpu_torch.client.scale import run_scale_poll
    from infimum_tpu_torch.groth16 import groth16 as g16
    from infimum_tpu_torch.maci.state import Poll

    walked, verified, sampled = [], [], []
    real = (Poll.prepare_public_inputs, native.groth16_verify, g16.prove)

    def walk(self, *a, **k):
        out = real[0](self, *a, **k)
        walked.append(out[0])
        return out

    def native_verify(*a, **k):
        ok = real[1](*a, **k)
        verified.append(ok)
        return ok

    def prove(pk, cs, witness, *a, **k):
        if not sampled:
            sampled.append((pk, cs, witness))
        return real[2](pk, cs, witness, *a, **k)

    Poll.prepare_public_inputs, native.groth16_verify, g16.prove = (
        walk, native_verify, prove)
    try:
        kernels.reset_counts()
        t0 = time.perf_counter()
        record = run_scale_poll(verbose=True, device="cuda")
        torch.cuda.synchronize()
        phase_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        Poll.prepare_public_inputs, native.groth16_verify, g16.prove = real
    log(f"[scale] {phase_s:.1f}s record {json.dumps(record)}")
    n_p, n_t = record["process_batches"], record["tally_batches"]
    if [walked.count("process"), walked.count("tally")] != [n_p, n_t]:
        raise AssertionError(f"walked {len(walked)} commitments, want "
                             f"{n_p} + {n_t}")
    want = record["sampled_process"] + record["sampled_tally"]
    if len(verified) != want or not all(verified) or want != 12:
        raise AssertionError(f"native verifications {verified}, want 12")
    idle = [k for k, n in launches.items() if n == 0 and k.startswith("msm_")]
    if idle:
        raise AssertionError(f"MSM kernels never launched in phase 8: {idle}")
    log(f"[scale] {n_p} + {n_t} commitments walked through the pallet's "
        f"prepare_public_inputs; {len(verified)} sampled proofs verified by "
        f"the native pairing; kernel launches {launches}; card {card_line()}")
    pk, cs, witness = sampled[0]
    kernel_vs_plain(pk, cs, witness, mul_rate, tag="scale ")


def zkey_phase(run, mul_rate) -> None:
    """Phase 9: the process circuit's zkey generated on the card, written
    to a file and read back (every field equal), two `prove_zkey` calls of
    the e2e's first process witness from the read zkey (the first encodes
    its queries), each proof verified by the native pairing and through
    the arkworks bytes, a tampered proof and a wrong public input
    rejected, all four MSM kernel instances launched; three steady
    `prove()` and `prove_zkey` calls of that witness in turns, with their
    stage traces; then each MSM kernel held against its plain version at
    the zkey's `h` shape."""
    import dataclasses
    import tempfile

    from infimum_tpu_torch import kernels, native
    from infimum_tpu_torch.curve.bn254_host import G1_GEN, g1_add
    from infimum_tpu_torch.curve.proj import G1_DEV
    from infimum_tpu_torch.groth16 import groth16 as g16, zkey as Z
    from infimum_tpu_torch.io import arkworks as ark, snarkjs

    cs = run.keys.process_circuit.cs
    witness, publics = run.first_process["witness"], run.first_process[
        "publics"]
    t0 = time.perf_counter()
    zk = Z.generate_zkey(cs, random.Random(ZKEY_SEED), device="cuda")
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "process.zkey")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(snarkjs.write_zkey(zk))
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            back = snarkjs.read_zkey(f.read())
        read_s = time.perf_counter() - t0
    differ = [f.name for f in dataclasses.fields(zk)
              if getattr(zk, f.name) != getattr(back, f.name)]
    if differ:
        raise AssertionError(f"zkey fields differ after the file: {differ}")
    log(f"[zkey] process zkey: {zk.n_vars} vars, domain {zk.domain_size}, "
        f"{len(zk.coeffs)} A/B coefficients; generate_zkey {gen_s:.3f}s on "
        f"the card, write_zkey {write_s:.3f}s, {size} bytes, read_zkey "
        f"{read_s:.3f}s; every field read back equal")
    del zk

    kernels.reset_counts()
    times, proofs = [], []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs.append(Z.prove_zkey(back, witness,
                                   rng=random.Random(ZKEY_SEED + 1 + i),
                                   device="cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    idle = [k for k, n in launches.items() if n == 0 and k.startswith("msm_")]
    if idle:
        raise AssertionError(f"MSM kernels never launched in phase 9: {idle}")
    vk = Z.vk_from_zkey(back)
    vk_bytes = ark.serialize_vkey(vk)
    for proof in proofs:
        proof_bytes = ark.serialize_proof(proof)
        if not native.groth16_verify(vk_bytes, proof_bytes, publics):
            raise AssertionError("prove_zkey proof rejected by native")
        if not g16.verify(ark.deserialize_vkey(vk_bytes),
                          ark.deserialize_proof(proof_bytes), publics):
            raise AssertionError("prove_zkey proof rejected after arkworks")
    proof = proofs[-1]
    if g16.verify(vk, g16.Proof(a=g1_add(proof.a, G1_GEN), b=proof.b,
                                c=proof.c), publics):
        raise AssertionError("tampered zkey proof accepted")
    if g16.verify(vk, proof, [publics[0] + 1] + publics[1:]):
        raise AssertionError("wrong public input accepted under the zkey")
    log(f"[zkey] prove_zkey first {times[0]:.3f}s (encodes the queries), "
        f"steady {times[1]:.3f}s; both proofs verify by the native pairing "
        f"and through the arkworks bytes; tampered proof and wrong public "
        f"input rejected; kernel launches {launches}; card {card_line()}")

    # the same witness through prove() and prove_zkey in turns, each with
    # its stage trace
    pk = run.keys.process_pk
    turns = {"prove": [], "prove_zkey": []}
    for _ in range(3):
        for name, call in (
                ("prove", lambda: g16.prove(pk, cs, witness, device="cuda")),
                ("prove_zkey", lambda: Z.prove_zkey(back, witness,
                                                    device="cuda"))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            turns[name].append(((time.perf_counter() - t0) * 1e3,
                                g16.LAST_PROVE_TRACE))
    for name, runs in turns.items():
        med = sorted(t for t, _ in runs)[1]
        log(f"[zkey] steady {name} in turns: median {med:.1f} ms of "
            f"{', '.join(f'{t:.1f}' for t, _ in runs)}; stage traces (s): "
            f"{'; '.join(json.dumps(tr) for _, tr in runs)}")

    p_odd = Z.odd_coset_rows(back, witness, "cuda")
    rows, sc, lanes = g16._msm_inputs(back, "h", back.h_query, p_odd, G1_DEV)
    msm_kernels("h", G1_DEV, rows, sc, lanes, mul_rate, tag="zkey ",
                compare=True)


def parallel_phase(run) -> None:
    """Phase 10: `prove_poll_results` of the e2e's poll with forked
    witness workers (INFIMUM_PARALLEL_WITNESS=1) and on its default
    thread, each from a fresh prover with the e2e's seed; equal batches
    byte for byte (every proof self-verified inside), equal outcomes, the
    workers' path taken once a circuit, no batch fallen back, all four MSM
    kernel instances launched in each run."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.client.e2e import poll_prover
    from infimum_tpu_torch.witness import parallel as WP

    saved = {k: os.environ.get(k) for k in ("INFIMUM_PARALLEL_WITNESS",
                                             "INFIMUM_WITNESS_TIMEOUT")}
    real = WP.iter_assignments
    calls = []

    def recording(circuit, batch_values, processes=None):
        calls.append(len(batch_values))
        return real(circuit, batch_values, processes)

    out = {}
    os.environ["INFIMUM_WITNESS_TIMEOUT"] = str(WITNESS_TIMEOUT_S)
    WP.iter_assignments = recording
    try:
        for mode in ("1", None):
            if mode is None:
                os.environ.pop("INFIMUM_PARALLEL_WITNESS", None)
            else:
                os.environ["INFIMUM_PARALLEL_WITNESS"] = mode
            prover = poll_prover(run.keys, run.pallet, run.coordinator,
                                 "cuda")
            fell = WP.FALLBACK_BATCHES
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches, outcome = prover.prove_poll_results()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            idle = [k for k, n in launches.items()
                    if n == 0 and k.startswith("msm_")]
            if idle:
                raise AssertionError(f"MSM kernels idle in phase 10: {idle}")
            if WP.FALLBACK_BATCHES != fell:
                raise AssertionError(f"{WP.FALLBACK_BATCHES - fell} batches "
                                     f"fell back to the parent")
            out[mode] = (batches, outcome, wall, list(calls), launches)
            calls.clear()
    finally:
        WP.iter_assignments = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    workers, thread = out["1"], out[None]
    if workers[0] != thread[0] or workers[1] != thread[1]:
        raise AssertionError("worker and thread runs differ")
    if len(workers[3]) != 2 or thread[3]:
        raise AssertionError(f"iter_assignments calls {workers[3]} with "
                             f"workers, {thread[3]} without")
    pools = [min(n, os.cpu_count() or 1) for n in workers[3]]
    log(f"[parallel] prove_poll_results with forked witness workers "
        f"{workers[2]:.3f}s (process {workers[3][0]} batches on {pools[0]} "
        f"workers, tally {workers[3][1]} on {pools[1]}; {os.cpu_count()} "
        f"CPUs), on one thread {thread[2]:.3f}s; {len(workers[0])} batches "
        f"equal byte for byte, every proof self-verified, outcomes equal; "
        f"no batch fell back (timeout {WITNESS_TIMEOUT_S} s); kernel "
        f"launches {workers[4]} / {thread[4]}; card {card_line()}")


def foreign_modules() -> list[str]:
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "infimum_tpu")]


def main() -> int:
    smoke_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.chdir(REPO)

    # 1. probe
    cap = torch.cuda.get_device_capability(0)
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" capability {cap[0]}.{cap[1]}")
    log(f"[probe] nvidia-smi: {card_line()}, max SM clock "
        f"{smi('clocks.max.sm')}")
    if cap != (9, 0):
        raise SystemExit(f"need compute capability 9.0, got {cap}")
    mul_rate = int32_mul_rate()
    log(f"[probe] int32 multiply rate {mul_rate:.4g}/s")

    # 2. build
    from infimum_tpu_torch import kernels

    kernels.library()
    log(f"[build] {kernels.BUILD_INFO['seconds']:.1f}s -> "
        f"{kernels.BUILD_INFO['path']}; per source: " + ", ".join(
            f"{src} " + ("cached" if t is None else f"{t:.1f}s")
            for src, t in kernels.BUILD_INFO["sources"].items()))
    log(kernels.BUILD_INFO["log"].strip())

    # 3. e2e at reference dims
    from infimum_tpu_torch import native
    from infimum_tpu_torch.client.e2e import run_reference_e2e

    if not native.available():
        raise SystemExit("native library did not load: verification would "
                         "not be the native pairing")
    from infimum_tpu_torch.groth16.pkcache import default_cache_dir

    os.makedirs(default_cache_dir(), exist_ok=True)
    cache_before = set(os.listdir(default_cache_dir()))
    kernels.reset_counts()
    t0 = time.perf_counter()
    run = run_reference_e2e(verbose=True, device="cuda")
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"[e2e] {e2e_s:.1f}s timings {json.dumps(run.timings)}")
    witness_native = run.keys.process_circuit.cs._native_prog() is not None
    log(f"[e2e] verifier: native pairing ({native._LIB_PATH}); witness: "
        f"{'native hint program' if witness_native else 'python hints'}")
    log(f"[e2e] kernel launches: {launches}")
    batch_times(run.timings)
    e2e_records(run.timings)
    cache_hit(run, cache_before)

    # 4. kernel vs plain on the first process proof's inputs
    first = run.first_process
    cmp = kernel_vs_plain(run.keys.process_pk, run.keys.process_circuit.cs,
                          first["witness"], mul_rate)
    steady_prove(run.keys.process_pk, run.keys.process_circuit.cs,
                 first["witness"], first["publics"])

    # 5. negative checks
    from infimum_tpu_torch.curve.bn254_host import G1_GEN, g1_add
    from infimum_tpu_torch.groth16.groth16 import Proof, verify

    vk, proof, publics = run.keys.process_pk.vk, first["proof"], first["publics"]
    if not verify(vk, proof, publics):
        raise AssertionError("first process proof no longer verifies")
    tampered = Proof(a=g1_add(proof.a, G1_GEN), b=proof.b, c=proof.c)
    if verify(vk, tampered, publics):
        raise AssertionError("tampered proof accepted")
    if verify(vk, proof, [publics[0] + 1] + publics[1:]):
        raise AssertionError("wrong public input accepted")
    log("[negative] tampered proof and wrong public input rejected")

    # 6. path checks
    missing = [k for k, n in launches.items()
               if n == 0 and k.startswith("msm_")]
    if missing:
        raise AssertionError(f"kernels never launched in the e2e: {missing}")
    if foreign_modules():
        raise AssertionError(f"JAX or infimum_tpu imported: "
                             f"{foreign_modules()[:5]}")
    log("[path] all MSM kernels launched in the e2e run; no JAX and no "
        "infimum_tpu module imported")

    # 7. Poseidon: the poll's trees, the benchmark's batch, every width
    launches["poseidon_perm"], tree_err = poll_trees(native)
    err, *rest = bench_batch(native, mul_rate)
    cmp["poseidon_perm"] = (max(err, tree_err), *rest)
    width_sweep(native)
    perm_resources()
    if launches["poseidon_perm"] == 0:
        raise AssertionError("poseidon_perm never launched in the trees")
    if foreign_modules():
        raise AssertionError(f"JAX or infimum_tpu imported: "
                             f"{foreign_modules()[:5]}")
    log(f"[path] poseidon_perm launched {launches['poseidon_perm']} times "
        f"for the poll's trees; no JAX and no infimum_tpu module imported")

    # 8. the largest legal poll
    scale_poll(mul_rate)
    if foreign_modules():
        raise AssertionError(f"JAX or infimum_tpu imported: "
                             f"{foreign_modules()[:5]}")

    # 9. the zkey path; 10. the parallel witness
    zkey_phase(run, mul_rate)
    parallel_phase(run)
    if foreign_modules():
        raise AssertionError(f"JAX or infimum_tpu imported: "
                             f"{foreign_modules()[:5]}")
    log(f"[path] no JAX and no infimum_tpu module imported; smoke "
        f"{time.perf_counter() - smoke_t0:.1f}s")

    report = []
    for name, source, replaces in KERNEL_ROWS:
        err, ms, plain_ms, bound_ms, bound_by = cmp[name]
        report.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[name],
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None))
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
