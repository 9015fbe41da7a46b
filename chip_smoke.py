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
     load log printed; whether the e2e ran setup (a key-cache miss: then
     each fixed-base kernel instance launched once a setup call),
     `setup_process`; then the process key loaded again from the cache
     (a hit: setup is not run), its load time beside the setup's, and a
     proof from the loaded key verified;
  4. kernels at the first process proof's shapes: at each of its five
     MSMs (`a`, `b1`, `l`, `h` over G1, `b2` over G2) the layout's
     kernels (`csrc/msm_layout.cu`: the recode launch, fed the prove's
     standard-form words and the query's infinity mask, which writes the
     scanned offsets too; the scatter) and the compaction kernel each
     equal to its plain version bit for bit and timed alone beside it and
     its bound, the recode beside the torch ops that left its path and
     torch.cumsum (the scan's yardstick), the whole layout beside the
     torch glue it replaced and torch.sort(stable) + gather; the layout
     stage and the accumulation kernel timed, with the mixed adds, the
     bound, the kernel's registers and its grid in waves; at `a` and `b2` each MSM
     kernel held against its plain torch version (equal emitted digits and
     limbs, equal window points as affine points) and timed; the weighted
     kernel's grid (at least one block per SM) and the adds its chunks cost
     beside the bound's; the H pipeline's kernels (`csrc/fr_rows.cu`,
     `csrc/fr_ntt.cu`; first their registers, shared memory and
     residency, a pass block's columns) at the process circuit's shape
     (2^18, B = 3, the first process witness) and the tally circuit's
     (2^14, a witness from a seed): the row launch on the witness's
     standard-form words and its merge-path split (items a thread, the
     most terms a thread takes beside the longest row, rows crossing a
     warp's end, waves), the tile launch of each transform (the coset
     NTT's with its input table, the iNTT's, the coset iNTT's in PRODUCT
     mode a.b - c at B = 1), the coset NTT's pass launch and the coset
     iNTT's with its output factors, and the row table's c R^2 encoding
     (the e2e's only pointwise launches, at key load: one chunk of the
     table's standard-form coefficients x R^3), each equal to its plain
     version bit for bit and timed, through its wrapper and as the kernel
     alone (queued behind a spin kernel), beside its bound and plain time,
     then the whole `h_rows` equal to `h_rows_plain` with its 7 launches
     counted against the plan, its time beside the sum of its launches'
     bounds and the function's own bound; a coset iNTT of 2^20 (one tile
     and two pass launches) held launch by launch against plain; then the
     median of three steady `prove()` calls of the first process batch
     with their stage traces, the H pipeline's host enqueue time beside
     its span on the card, every kernel's launches in one steady prove
     (the H stage's as planned, no pointwise launch; every MSM kernel
     once an MSM, each recode fed (n, 8) int32 words and no padded
     copy) and a profiled steady prove's device kernel count and
     busy time, whole and by kernel group;
  5. negative checks: a tampered proof and a wrong public input are
     rejected;
  6. path checks: every MSM kernel and every H pipeline kernel was
     launched in the e2e run, and no module of JAX or of the JAX package
     `infimum_tpu` was imported;
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
     2^18): `generate_zkey` on the card (one launch of each fixed-base
     instance, each call's encoding, device part and decode timed),
     `write_zkey` to a file and
     `read_zkey` back, every field equal, the file's size and each step's
     seconds; `prove_zkey` of phase 3's first process witness twice from
     the read zkey (the first encodes the queries, the second is steady),
     each proof verified by the native pairing under `vk_from_zkey` and
     through the arkworks bytes, a tampered proof and a wrong public input
     rejected, all four MSM kernel instances launched; three steady
     `prove()` and `prove_zkey` calls of that witness in turns, each with
     its stage trace; each MSM kernel held against its plain version at
     the zkey's `h` shape (2^18 rows); the H kernels at the zkey's odd
     coset (A and B rows, generator w_2m, no division by Z), as in phase
     4 with the iNTT's tile gathering a, b and c = a.b (AB mode) and the
     pointwise step a.b - c, 6 launches, the pass launches there and at
     phase 4's process shape in turns, and `odd_coset_rows` against
     `odd_coset_rows_plain`; the fixed-base kernel (`csrc/fixed_base.cu`)
     equal to its plain version bit for bit (affine standard-form words)
     over every scalar of `generate_zkey`'s two calls, 1,024 decoded
     points a curve equal to the host multiply, timed alone at the full
     shape beside its bound with and without the affine epilogue, its
     registers, resident blocks and waves, and the plain version's time
     at the full shape;
 10. the parallel witness: `PollProver.prove_poll_results` of the e2e's
     poll with forked witness workers (INFIMUM_PARALLEL_WITNESS=1) and on
     its default thread, each from a fresh prover with the e2e's seed, the
     batches equal byte for byte, no batch fallen back to the parent
     within a 120 s timeout, both wall times and the worker count printed;
 11. the multi-GPU slice: `infimum_tpu_torch.parallel` over
     torch.distributed, one spawned process a rank (NCCL at D = 1; D = 2
     and 4 over NCCL where there are as many cards, else over gloo on the
     cards there are; the quinary tree's D = 5 over gloo), the inputs
     reaching the ranks through files: the sharded MSM of the process
     key's `h` rows with the first witness's H scalars (weak, 2^18 a rank,
     and strong, 2^18 over D), of those rows tiled to 2^20 with scalars
     from a seed, and of the `b2` query (141,312 G2 rows), by both
     reductions, each equal as an affine point to the one-card MSM of the
     same rows; the cross-rank sum (`csrc/point_sum.cu`, one launch a
     reduction or a round from D = 2 on) equal on every rank to its plain version on
     every rank's window sums and to the gather's sum, a permute round
     timed plain against the kernel, and the kernel alone at D = 2, 4, 8
     beside its bound; the 2^18 NTT (slab in words, the twiddle product
     through `fr_pointwise`, timed alone at rank 0's slab for D = 1, 2,
     4) forward equal to the one-card `ntt` in k-form
     and its round trip exact; the poll's (2, 10) tree at D = 1, 2, 4 and
     (5, 6) tree at D = 1, 5 equal to phase 7's native roots; every rank's
     launch counts gathered (every MSM kernel instance and both sum
     instances on every rank of an MSM run, the NTT's tile and pointwise
     launches on every rank of an NTT run, the Poseidon kernel on every
     rank of a tree run) and
     no JAX on any rank; the bytes each reduction moved equal to
     `reduction_comm_bytes`; each world's backend, cards and per-rank
     CUDA-event ms, and one `msm_scaling` record line.
`python3 chip_smoke.py --multi-gpu` runs phases 1-3, 7(a) and 11 only:
the run on several cards, where phases 4-10 would repeat one card's.
The last three lines of standard output are a JSON line with each kernel's
launches (the e2e's, the fixed-base kernels' with `generate_zkey`'s,
phase 11's summed over its ranks), error, times and bound, then the
card's name and power limit;
the very last line is the result: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import multiprocessing
import os
import random
import re
import signal
import subprocess
import sys
import time

import numpy as np
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
    # counterparts of the JAX package's compiled H stage (XLA programs,
    # not Pallas kernels): row evaluation, the NTT family, and the pointwise
    # step, which on the main path encodes the row table (c R^2) at key load
    # in place of the reference's per-prove witness encoding
    ("fr_rows", "infimum_tpu_torch/csrc/fr_rows.cu",
     "infimum_tpu/groth16/rowval.py:92"),
    ("fr_ntt_tile", "infimum_tpu_torch/csrc/fr_ntt.cu",
     "infimum_tpu/ntt/ntt.py:121"),
    ("fr_ntt_pass", "infimum_tpu_torch/csrc/fr_ntt.cu",
     "infimum_tpu/ntt/ntt.py:121"),
    ("fr_pointwise", "infimum_tpu_torch/csrc/fr_ntt.cu",
     "infimum_tpu/groth16/rowval.py:87; infimum_tpu/parallel/ntt.py:124"),
    # counterparts of the glue inside the JAX package's compiled MSM program
    # `_msm_fn` (XLA ops, not Pallas kernels): the recode scan over the
    # windows (with the block histograms and their scan, the counting half
    # of the sort, in the same launch), each window's stable sort_key_val
    # with the gather of the signs (the scatter), and the compaction's
    # .at[dest].set
    ("msm_recode_g1", "infimum_tpu_torch/csrc/msm_layout.cu",
     "infimum_tpu/msm/pallas_msm.py:441"),
    ("msm_recode_g2", "infimum_tpu_torch/csrc/msm_layout.cu",
     "infimum_tpu/msm/pallas_msm.py:441"),
    ("msm_scatter_g1", "infimum_tpu_torch/csrc/msm_layout.cu",
     "infimum_tpu/msm/pallas_msm.py:446"),
    ("msm_scatter_g2", "infimum_tpu_torch/csrc/msm_layout.cu",
     "infimum_tpu/msm/pallas_msm.py:446"),
    ("msm_compact_g1", "infimum_tpu_torch/csrc/msm_layout.cu",
     "infimum_tpu/msm/pallas_msm.py:463"),
    ("msm_compact_g2", "infimum_tpu_torch/csrc/msm_layout.cu",
     "infimum_tpu/msm/pallas_msm.py:463"),
    # counterparts of the JAX package's last compiled programs (XLA, not
    # Pallas): the fixed-base multiply of setup and zkey generation, and
    # the sharded MSM's cross-rank sum inside shard_map
    ("fixed_base_g1", "infimum_tpu_torch/csrc/fixed_base.cu",
     "infimum_tpu/msm/fixed_base.py:59"),
    ("fixed_base_g2", "infimum_tpu_torch/csrc/fixed_base.cu",
     "infimum_tpu/msm/fixed_base.py:59"),
    ("point_sum_g1", "infimum_tpu_torch/csrc/point_sum.cu",
     "infimum_tpu/parallel/msm.py:31"),
    ("point_sum_g2", "infimum_tpu_torch/csrc/point_sum.cu",
     "infimum_tpu/parallel/msm.py:31"),
)
# every MSM kernel instance: a prove launches each of them
MSM_KERNELS = tuple(name for name, *_ in KERNEL_ROWS
                    if name.startswith("msm_"))
SUM_KERNELS = ("point_sum_g1", "point_sum_g2")
# Bounds: the larger of bytes over the memory rate and 32-bit multiplies
# over their rate. HBM3 of an H100 SXM: 3.35 TB/s (NVIDIA's data sheet).
# 32-bit integer multiply and multiply-add: 64 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of arithmetic
# instructions), times the SM count and the card's maximum SM clock. A
# Montgomery product (CIOS over 8 words) takes 8 x (8 + 1 + 8) products,
# each low and high half: 264 multiplies.
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32                 # the unit of an L2 / HBM transaction
INT32_MULS_PER_CLOCK_SM = 64
MULS_PER_MONT = 264
# Fq products per complete add (RCB Alg. 7) and per mixed add (Alg. 8): an
# Fq2 product is 3 Fq products, and so is the G2 3b product (one Fq2
# product by the constant, Fq2OutOfLine::b3); the G1 3b product is
# additions.
ADD_MULS = {"g1": 12, "g2": 12 * 3 + 2 * 3}
MIXED_MULS = {"g1": 11, "g2": 11 * 3 + 2 * 3}
ACCUM_FIELD = {"g1": "11FqOutOfLine", "g2": "12Fq2OutOfLine"}
SIGNUPS, MESSAGES = 1022, 15624   # client/scale.py: the largest legal poll
POLL_SEED, BENCH_SEED = 20260820, 20260819
ZKEY_SEED = 20260821
H_SEED = 20260823
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
    (name, curve, rows, scalars, mask, lanes) for `a`, `b1`, `l`, `h` (G1)
    and `b2` (G2); the scalars the prove's standard-form words (the
    witness's, its slice from the public values for `l`, H's), which the
    recode pads to the rows and masks by the query's infinity mask."""
    from infimum_tpu_torch.curve.proj import G1_DEV, G2_DEV
    from infimum_tpu_torch.groth16.groth16 import (
        _domain_size, _msm_inputs, h_words,
    )
    from infimum_tpu_torch.groth16.rowval import ints_to_words

    w = ints_to_words(witness, "cuda")
    npub, m = cs.num_public + 1, _domain_size(cs)
    return [(name, curve, *_msm_inputs(pk, name, points, scalars, curve))
            for name, points, curve, scalars in (
                ("a", pk.a_query, G1_DEV, w), ("b1", pk.b_g1_query, G1_DEV, w),
                ("l", pk.l_query, G1_DEV, w[npub:]),
                ("h", pk.h_query, G1_DEV, h_words(cs, w, "cuda")[:m - 1]),
                ("b2", pk.b_g2_query, G2_DEV, w))]


RESOURCES = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
    r"spill stores, (\d+) bytes spill loads(?:\nptxas info\s*: Used (\d+) "
    r"registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?)?")


def kernel_resources(kernel: str, field: str) -> str:
    """A kernel instance's registers, stack and spills from nvcc's
    --resource-usage report of this run's build: the function whose
    mangled name holds `kernel` and `field` (its field type's)."""
    from infimum_tpu_torch import kernels

    for m in RESOURCES.finditer(kernels.BUILD_INFO.get("log", "")):
        if kernel in m.group(1) and field in m.group(1):
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
    """Hold the layout's and the compaction's kernels against their plain
    versions and time them, with the accumulation kernel, at the five MSM
    shapes of a process proof; at `a` (G1) and `b2` (G2) also compare the
    accumulation and weighted kernels with their plain versions. Returns
    per-kernel rows (error, ms, plain ms, bound ms, bound by[, library
    ms]) at `a` and `b2`. `tag` goes before each line's label."""
    rows_out = {}
    for name, curve, rows, sc, mask, lanes in query_inputs(pk, cs, witness):
        rows_out.update(msm_kernels(name, curve, rows, sc, mask, lanes,
                                    mul_rate, tag,
                                    compare=name in ("a", "b2")))
    return rows_out


def msm_kernels(name, curve, rows, sc, mask, lanes, mul_rate, tag="",
                compare=False) -> dict:
    """One MSM's layout and compaction kernels (`layout_kernels`,
    `compact_kernel`) and its accumulation kernel timed, with the mixed
    adds, the bound, the kernel's registers and its grid in waves;
    with `compare`, each MSM kernel held against its plain torch version
    (equal emitted digits and limbs, equal window points as affine points)
    and timed. Returns per-kernel rows (error, ms, plain ms, bound ms,
    bound by) when it compares, else nothing."""
    from infimum_tpu_torch.msm import msm as M

    spec = M.SPECS[curve.name]
    N = rows.shape[0]
    glue, layout = layout_kernels(name, spec, rows, sc, mask, lanes,
                                  mul_rate, tag)
    acc_ms, (edig, ept) = cuda_ms(lambda: M.accumulate(*layout, spec), 3,
                                  warm=1)
    glue.update(compact_kernel(name, spec, edig, ept, lanes, mul_rate, tag))
    # the least work these inputs need: one mixed add per entry whose
    # digit repeats the one before it in its lane (and is not 0)
    sdig = layout[0]
    mixed = int(((sdig[..., 1:] == sdig[..., :-1]) & (sdig[..., 1:] != 0))
                .sum())
    acc_bound = bound(nbytes(*layout, edig, ept),
                      mixed * MIXED_MULS[curve.name], mul_rate)
    blocks, live, resident = accum_grid(sdig, lanes, curve.name)
    log(f"[{tag}accum] {name} ({curve.name}, {N} rows, {lanes} lanes, T "
        f"{N // lanes}): kernel {acc_ms:.3f} ms;"
        f" {mixed} mixed adds, bound {acc_bound[0]:.3f} ms "
        f"({acc_bound[1]}), {acc_bound[0] / acc_ms:.1%} of bound; "
        f"{kernel_resources('msm_accum_kernel', ACCUM_FIELD[curve.name])}; "
        f"grid {blocks} blocks, {live} "
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
                                           *wt_bound), **glue}


def layout_kernels(name, spec, rows, sc, mask, lanes, mul_rate,
                   tag="") -> tuple:
    """The layout's kernels (csrc/msm_layout.cu) at one MSM's shape: the
    recode launch from the prove's standard-form words (padding to the
    table's rows and the query's infinity mask in the kernel) to packed,
    offsets and totals, and the scatter, each held bit for bit against its
    plain version on the same inputs (the recode's: `layout_recode_plain`
    and `layout_scan_plain`), timed alone (10 calls behind a spin kernel)
    beside its plain version and its bound (bytes: no products; the
    recode's counting the words of the live unmasked rows, the mask,
    packed, the offsets and totals once, and beside it the bound with the
    scan's reread and rewrite of the counts charged); beside the recode,
    the torch ops that left the path (the words' conversion to limbs and
    the padded, masked int64 copy) alone and torch.cumsum(counts, 1), the
    scan's library yardstick; then the whole layout through its wrappers
    against `lane_layout_plain` from the table's limbs (the torch glue the
    kernels replaced: the recode, the stable sort, the sign gather and
    the table's conversion) and against torch.sort(stable=True) plus the
    gather of the signs (the library call). Returns rows (error, ms, plain
    ms, bound ms, bound by[, library ms]) of the curve's recode and
    scatter, and the layout, the accumulation kernel's inputs."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.msm import msm as M

    reps, c = 10, spec.name
    N, n = rows.shape[0], sc.shape[0]
    if sc.dtype != torch.int32 or sc.shape[1] != 8:
        raise AssertionError(f"{name}: the recode is fed {sc.dtype} "
                             f"{tuple(sc.shape)}, not the prove's words")
    packed, offsets, totals = M.layout_recode(sc, spec, N, mask)
    p_packed, p_counts = M.layout_recode_plain(sc, spec, N, mask)
    counts = p_counts.clone()
    p_totals = M.layout_scan_plain(p_counts)
    got = M.layout_scatter(packed, offsets, totals, spec)
    want = M.layout_scatter_plain(packed, offsets, totals, spec)
    whole = M.lane_layout(rows, sc, lanes, spec, mask)
    limbs = M.words_to_limbs(rows) if rows.dtype == torch.int32 else rows
    before = M.lane_layout_plain(limbs, sc, lanes, spec, mask)
    checks = {
        "recode": all(torch.equal(g, w) for g, w in zip(
            (packed, offsets, totals), (p_packed, p_counts, p_totals))),
        "scatter": all(torch.equal(g, w) for g, w in zip(got, want)),
        "lane_layout": all(torch.equal(g, w) for g, w in zip(whole, before))}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{name}: {bad} differ from their plain versions")

    def plain_recode():
        out = M.layout_recode_plain(sc, spec, N, mask)
        return out, M.layout_scan_plain(out[1])

    times = {
        "recode": (alone_ms(lambda: M.layout_recode(sc, spec, N, mask),
                            reps)[0], cuda_ms(plain_recode, 3, warm=1)[0]),
        "scatter": (alone_ms(lambda: M.layout_scatter(
            packed, offsets, totals, spec), reps)[0], cuda_ms(
            lambda: M.layout_scatter_plain(packed, offsets, totals, spec), 3,
            warm=1)[0])}
    live = n if mask is None else n - int(mask[:n].sum())
    recode_bytes = (live * 32 + (0 if mask is None else n)
                    + nbytes(packed, offsets, totals))
    bounds = {"recode": bound(recode_bytes, 0, mul_rate),
              "scatter": bound(nbytes(packed, offsets, totals, *got), 0,
                               mul_rate)}
    rescan = bound(recode_bytes + 2 * nbytes(offsets), 0, mul_rate)[0]
    torch_ops_ms = alone_ms(lambda: M.padded_limbs(sc, N, mask), reps)[0]
    cumsum_ms = alone_ms(lambda: torch.cumsum(counts, 1), reps)[0]
    mags, sgns = M.recode(M.padded_limbs(sc, N, mask), spec)
    lib_ms = cuda_ms(lambda: sgns.gather(1, torch.sort(
        mags, dim=1, stable=True)[1]), 3, warm=1)[0]
    whole_ms = cuda_ms(lambda: M.lane_layout(rows, sc, lanes, spec, mask), 3,
                       warm=1)[0]
    before_ms = cuda_ms(lambda: M.lane_layout_plain(limbs, sc, lanes, spec,
                                                    mask), 3, warm=1)[0]
    fn_bound = bound(recode_bytes + nbytes(*got), 0, mul_rate)
    nwin, nblk, bins = offsets.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = kernels.scatter_blocks_per_sm(c) * sms
    items = nblk * -(-nwin // spec.recode_group)
    grid = min(items, kernels.recode_blocks_per_sm(c) * sms)
    log(f"[{tag}layout] {name} ({c}, {n} scalars of {N} rows "
        f"({n - live} masked) x {nwin} windows, {nblk} blocks of "
        f"{spec.layout_chunk} a window, {bins} bins; the recode's {items} "
        f"items on a grid of {grid}; the scatter's {nblk * nwin} blocks, "
        f"{resident} resident = {nblk * nwin / resident:.2f} waves): "
        + "; ".join(
            f"{k} {ms:.4f} ms alone (plain {p:.3f}), bound {bounds[k][0]:.4f}"
            f" ({bounds[k][1]}), {bounds[k][0] / ms:.1%} of bound"
            for k, (ms, p) in times.items())
        + f"; the recode's bound with the scan's reread and rewrite of the "
        f"counts {rescan:.4f} ({rescan / times['recode'][0]:.1%}); the "
        f"torch ops that left the path (limbs, padded and masked) "
        f"{torch_ops_ms:.4f} ms alone; torch.cumsum(counts, 1) "
        f"{cumsum_ms:.4f} ms alone; the layout {whole_ms:.4f} ms through its"
        f" wrappers (the function's bound {fn_bound[0]:.4f}, "
        f"{fn_bound[0] / whole_ms:.1%}) against the torch glue it replaced "
        f"{before_ms:.3f} ms and torch.sort(stable) + gather {lib_ms:.3f} "
        f"ms; every kernel equal to its plain version; card {card_line()}")
    return ({f"msm_recode_{c}": (0, *times["recode"], *bounds["recode"]),
             f"msm_scatter_{c}": (0, *times["scatter"], *bounds["scatter"],
                                  lib_ms)}, whole)


def compact_kernel(name, spec, edig, ept, lanes, mul_rate, tag="") -> dict:
    """The compaction kernel at one MSM's shape on the accumulation
    kernel's emissions: equal to `compact_plain` bit for bit, timed alone
    beside it and its bound (bytes: the emitted digits, the live
    emissions' words, the packed slots). Returns its row."""
    from infimum_tpu_torch.msm import msm as M

    K = spec.n_buckets + lanes + 2
    got = M.compact(edig, ept, K)
    want = M.compact_plain(edig, ept, K)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: compaction differs from plain")
    ms = alone_ms(lambda: M.compact(edig, ept, K), 10)[0]
    plain_ms = cuda_ms(lambda: M.compact_plain(edig, ept, K), 3, warm=1)[0]
    nwin, T1, PW, L = ept.shape
    live = int((got[0] > 0).sum())
    least = bound(nbytes(edig, *got) + live * PW * 4, 0, mul_rate)
    # the floor ept's lane-minor layout sets: a 32-byte sector a live word
    sectors = live * PW * SECTOR_BYTES
    log(f"[{tag}compact] {name} ({spec.name}, {nwin} windows x {T1} x {L} "
        f"emissions, ept {nbytes(ept) / 1e6:.1f} MB; {live} live, "
        f"{live / edig.numel():.2%}; K {K}): kernel {ms:.4f} ms alone, plain "
        f"{plain_ms:.3f} ms, bound {least[0]:.4f} ({least[1]}), "
        f"{least[0] / ms:.1%} of bound; the live words' sectors "
        f"{sectors / 1e6:.1f} MB, floor {sectors / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms at the HBM rate; equal to plain; card {card_line()}")
    return {f"msm_compact_{spec.name}": (0, ms, plain_ms, *least)}


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
    verify. Then the H pipeline alone, three times from the witness's
    ints and three times from its words on the card: the host's time to
    enqueue it beside the card's span by CUDA events, and the host's one
    conversion of the witness; then every kernel's launches in one steady
    prove and a profiled steady prove."""
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
    # card's span from its first launch to its last, from the witness's
    # ints (the host's conversion included, as `h_dispatch` pays it) and
    # from its words on the card (the kernels' launches alone)
    from infimum_tpu_torch.groth16.rowval import ints_to_words

    conv = []
    for _ in range(3):
        t0 = time.perf_counter()
        ww = ints_to_words(witness, "cuda")
        torch.cuda.synchronize()
        conv.append(f"{(time.perf_counter() - t0) * 1e3:.1f}")
    for label, w in (("from ints", witness), ("from words", ww)):
        spans = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            g16.h_rows(cs, w, "cuda")
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            spans.append(f"host {host_ms:.1f} / card "
                         f"{start.elapsed_time(end):.1f}")
        log(f"[prove] H pipeline (h_rows) {label} ms, host enqueue / card "
            f"span: {'; '.join(spans)}")
    log(f"[prove] the witness's one host conversion to words on the card "
        f"(ints_to_words, {len(witness)} values) ms: {', '.join(conv)}")
    prove_launches(pk, cs, witness)
    traced_prove(pk, cs, witness)
    return runs[1][0]


# the device kernels of a traced prove, grouped by the name each contains
# (the recode's one grid, its scan included, is msm_recode_kernel; the
# compaction's three grids msm_compact_count_kernel,
# msm_compact_list_kernel and msm_compact_gather_kernel)
TRACE_GROUPS = ("fr_rows", "fr_ntt_tile", "fr_ntt_pass", "fr_pointwise",
                "msm_accum", "msm_weighted", "msm_recode", "msm_scatter",
                "msm_compact")


def traced_prove(pk, cs, witness) -> None:
    """One more steady prove() under `utils.profiling.trace`, its Chrome
    trace written to a temporary INFIMUM_PROFILE_DIR and read back: the
    device kernels it launched (the profiled prove's kernel count), the
    card's busy time (the union of its kernels, copies and sets) against
    the prove's host clock, and the kernels and their busy time by group
    (`TRACE_GROUPS`). The profiler slows
    the host, so read the busy time and the counts, not the wall time."""
    import tempfile

    from infimum_tpu_torch.groth16 import groth16 as g16
    from infimum_tpu_torch.utils.profiling import trace

    saved = os.environ.get("INFIMUM_PROFILE_DIR")
    with tempfile.TemporaryDirectory() as out:
        os.environ["INFIMUM_PROFILE_DIR"] = out
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace("steady_process_prove"):
                g16.prove(pk, cs, witness, device="cuda")
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            if saved is None:
                os.environ.pop("INFIMUM_PROFILE_DIR", None)
            else:
                os.environ["INFIMUM_PROFILE_DIR"] = saved
        with open(os.path.join(out, "steady_process_prove.json")) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    names: dict = {}
    group_us: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            key = e.get("name", "?")
            key = next((k for k in TRACE_GROUPS if k in key), "other")
            names[key] = names.get(key, 0) + 1
            group_us[key] = group_us.get(key, 0.0) + e["dur"]
    kernels = sum(names.values())
    log(f"[prove] profiled steady prove(): {kernels} device kernels "
        f"({json.dumps(names)}), {len(spans) - kernels} copies and sets; "
        f"card busy ms by kernel group "
        f"{json.dumps({k: round(v / 1e3, 4) for k, v in group_us.items()})}; "
        f"card busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms under the "
        f"profiler (idle share {1 - busy / wall_us:.3f}); card "
        f"{card_line()}")
    if kernels == 0:
        raise AssertionError("the profiler saw no device kernel")


# -- the H pipeline's kernels (phases 4 and 9) --------------------------------------

H_KERNELS = ("fr_rows", "fr_ntt_tile", "fr_ntt_pass", "fr_pointwise")
# launches of one H stage: the rows, then a tile and a pass a transform
# (three transforms; the zkey's two and its final pointwise step)
H_LAUNCHES = {"process": 7, "tally": 7, "zkey": 6}
VALUE_BYTES = 32                   # one Fr value: 8 words
SPIN_CYCLES = 20_000_000           # torch.cuda._sleep: about 10 ms


def alone_ms(fn, reps: int):
    """(the card's ms a call, the host's enqueue ms, the spin's ms) of
    `reps` calls of fn() queued behind a spin kernel (torch.cuda._sleep):
    the CUDA events around the calls open once the spin ends, so they time
    the calls' kernels back to back, not the wrapper's Python between
    launches. Raises if the host had not enqueued them all by then."""
    fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = spin.elapsed_time(start)
    if enqueue >= spin_ms:
        raise AssertionError(f"the host took {enqueue:.3f} ms to enqueue "
                             f"{reps} calls, the spin only {spin_ms:.3f}")
    return start.elapsed_time(end) / reps, enqueue, spin_ms


def rows_work(sp, m: int, nv: int):
    """(bytes, Fr products) of one row launch (both its grids): its
    partition (the row ends, each thread's start, the rows crossing a
    warp's end), each term's column and coefficient, each of the nv
    witness values read once (the witness fits in L2 however often the
    terms name it), each row written once."""
    part = sp.partition(m)
    return (nbytes(part.ends, part.slices, part.cross)
            + sp.nnz * (4 + VALUE_BYTES) + nv * VALUE_BYTES
            + sp.nmat * m * VALUE_BYTES, sp.nnz)


def twiddle_products(n: int, s0: int, s1: int) -> int:
    """Fr products of stages s0..s1 of one transform of n values: the
    butterflies whose twiddle is not 1 (stage s has n / 2^s whose twiddle
    is 1)."""
    return sum(n // 2 - (n >> s) for s in range(s0, s1 + 1))


def gather_counts(B: int, mode: int):
    """(input transforms read, products the gather fuses, over n each) of
    a tile launch writing B transforms in gather `mode`."""
    from infimum_tpu_torch.ntt import ntt as N

    return {N.VALUE: (B, 0), N.PRODUCT: (3 * B, B),
            N.AB: (2 * B // 3, B // 3)}[mode]


def tile_work(B: int, logn: int, pre: bool, post: int, mode: int = 0):
    """(bytes, Fr products) of one tile launch writing B transforms at the
    tile of ntt/ntt.py: the values in (by gather mode: one, three or two
    thirds a transform) and out, the twiddles of its stages, the input
    table, the output multiplies (`post` factors, a table of n where 2),
    the gather's products (a.b)."""
    from infimum_tpu_torch.ntt import ntt as N

    n, tlog = 1 << logn, min(logn, N.TILE_LOG)
    ins, fused = gather_counts(B, mode)
    return ((ins * n + B * n + (1 << tlog) - 1 + n * pre + n * (post == 2))
            * VALUE_BYTES,
            B * twiddle_products(n, 1, tlog) + n * (B * (pre + post) + fused))


def pass_work(B: int, logn: int, s0: int, s1: int, post: int):
    """(bytes, Fr products) of the pass launch of stages s0..s1: the
    values in and out once, those stages' twiddles once, the output table
    where `post` is 2."""
    n = 1 << logn
    return (2 * B * n * VALUE_BYTES + ((1 << s1) - (1 << (s0 - 1)))
            * VALUE_BYTES + (n * VALUE_BYTES if post == 2 else 0),
            B * (twiddle_products(n, s0, s1) + n * post))


def pointwise_work(n: int, b: bool, c: bool, k: bool):
    """(bytes, Fr products) of a pointwise launch over n values."""
    return ((2 + b + c) * n * VALUE_BYTES + (VALUE_BYTES if k else 0),
            n * (b + k))


def h_launches(sp, m: int, nv: int, zkey: bool):
    """Every launch of one `h_rows` (or, with `zkey`, `odd_coset_rows`) at
    domain m, the tile and the pass plan of ntt/ntt.py: [(kernel, bytes,
    Fr products)], in order."""
    from infimum_tpu_torch.ntt import ntt as N

    logm = m.bit_length() - 1
    plan = N.pass_plan(logm)
    out = [("fr_rows", *rows_work(sp, m, nv))]
    for B, pre, post, mode in h_transforms(zkey):
        out.append(("fr_ntt_tile", *tile_work(
            B, logm, pre, 0 if plan else post, mode)))
        for s0, s1 in plan:
            out.append(("fr_ntt_pass", *pass_work(
                B, logm, s0, s1, post if s1 == logm else 0)))
    if zkey:
        out.append(("fr_pointwise", *pointwise_work(m, True, True, True)))
    return out


def h_transforms(zkey: bool):
    """(transforms out, input table, output factors, gather mode) of each
    transform of the H stage: the iNTT (x 1/n; the zkey's gathers a, b
    and a.b from its two rows), the coset NTT, and unless `zkey` the coset
    iNTT of a.b - c (x 1/(nZ) and the inverse coset powers, a table)."""
    from infimum_tpu_torch.ntt import ntt as N

    return [(3, False, 1, N.AB if zkey else N.VALUE),
            (3, True, 0, N.VALUE)] + (
        [] if zkey else [(1, False, 2, N.PRODUCT)])


def h_function_work(sp, m: int, nv: int, zkey: bool):
    """(bytes, Fr products) of the whole stage with each step's values
    read and written once: the launches' row and pointwise work, and each
    transform as one pass (its values in and out, its whole twiddle table
    and its tables once); the same Fr products as the launches. Where a
    transform's stages above the tile need more than one pass launch, the
    design moves more than this."""
    plan = h_launches(sp, m, nv, zkey)
    moved = sum(b for name, b, _ in plan
                if name in ("fr_rows", "fr_pointwise"))
    moved += sum((gather_counts(B, mode)[0] * m + B * m + (m - 1) + m * pre
                  + m * (post == 2)) * VALUE_BYTES
                 for B, pre, post, mode in h_transforms(zkey))
    return moved, sum(p for _, _, p in plan)


H_RESOURCE_NAMES = (
    ("fr_rows_kernel", "fr_rows"), ("fr_rows_carry_kernel", "fr_rows carry"),
    ("fr_ntt_tile_kernel", "fr_ntt_tile"),
    ("fr_ntt_pass_kernel", "fr_ntt_pass"),
    ("fr_pointwise_kernel", "fr_pointwise"))


def h_resources() -> None:
    """The H kernels' registers, spills and static shared memory from
    nvcc's --resource-usage report of this run's build, each tile's and
    pass's block, dynamic shared memory and resident blocks an SM (CUDA's
    occupancy calculator), and the columns a pass block takes at the main
    path's shapes."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.ntt import ntt as N

    text = kernels.BUILD_INFO.get("log", "")
    found = []
    for m in RESOURCES.finditer(text):
        label = next((lab for key, lab in H_RESOURCE_NAMES
                      if key in m.group(1)), None)
        if label:
            smem = re.match(r"[^\n]*?(\d+) bytes smem", text[m.end():])
            found.append(f"{label}: {m.group(5)} registers, "
                         f"{smem.group(1) if smem else 0} B static shared, "
                         f"{m.group(2)} B stack, {m.group(3)}/{m.group(4)} B "
                         f"spill stores/loads")
    cols = "; ".join(
        f"{name} 2^{logn} B = {B}, {L} stages: 2^"
        f"{kernels.query('inf_fr_ntt_pass_col_log', B, logn, L)} columns"
        for name, logn in (("process", 18), ("tally", 14))
        for B in (3, 1) for L in (logn - N.TILE_LOG,))
    log(f"[h] resources (nvcc -Xptxas -v): "
        f"{'; '.join(found) or 'not in this run (cached build)'}; tile "
        f"2^{N.TILE_LOG}: {min(256, 1 << (N.TILE_LOG - 2))} threads, "
        f"{32 << N.TILE_LOG} B dynamic shared, "
        f"{kernels.query('inf_fr_ntt_tile_blocks_per_sm')} blocks an SM; "
        f"pass (at most {N.PASS_LOG} stages, 2^11 values, 256 threads, "
        f"65536 B dynamic shared): "
        f"{kernels.query('inf_fr_ntt_pass_blocks_per_sm')} blocks an SM; "
        f"a pass block's columns: {cols}; "
        f"rows: {kernels.query('inf_fr_rows_block')} threads, "
        f"{kernels.query('inf_fr_rows_blocks_per_sm')} blocks an SM")


def row_partition_line(label: str, sp, m: int) -> None:
    """The row launch's split at domain m: items a thread and a warp, the
    most terms any thread takes beside the longest row, the rows crossing
    a warp's end, the grid in waves."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.groth16 import rowval as RV

    part = sp.partition(m)
    ends, slices, cross = part.host
    step = np.diff(slices, axis=0)
    block = kernels.query("inf_fr_rows_block")
    blocks = -(-part.nwarps * 32 // block)
    slots = kernels.query("inf_fr_rows_blocks_per_sm") * \
        torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[h {label}] fr_rows partition: {RV.ROW_ITEMS} items (terms and "
        f"row ends) a thread, {32 * RV.ROW_ITEMS} a warp; {part.nwarps} "
        f"warps over {ends.shape[0]} output rows and {sp.nnz} terms; the "
        f"most terms one thread takes {int(step[:, 1].max())}, the most "
        f"items {int(step.sum(1).max())} (longest row {sp.longest}); "
        f"{part.ncross} rows cross a warp's end, the longest "
        f"{int((cross[:, 2] - cross[:, 1]).max(initial=0))} warps; "
        f"{blocks} blocks of {block} threads, {slots} resident "
        f"({blocks / slots:.2f} waves)")


def pass_turns(label: str, mine, other, logm: int, tw, reps: int = 10):
    """The pass launches of a B = 3 coset NTT on phase 4's process input
    and on this phase's input in turns, each run timed alone by CUDA
    events on a copy made before the timing."""
    from infimum_tpu_torch.ntt import ntt as N

    times = {"process": [], label: []}
    pools = {"process": [other.clone() for _ in range(reps)],
             label: [mine.clone() for _ in range(reps)]}
    for i in range(reps):
        for name, xs in pools.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for s0, s1 in N.pass_plan(logm):
                N.ntt_pass(xs[i], logm, s0, s1, tw)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    log(f"[h {label}] fr_ntt_pass in turns, each transform's passes alone "
        f"(ms): " + "; ".join(f"{name} mean {sum(t) / len(t):.4f} min "
                              f"{min(t):.4f}" for name, t in times.items())
        + f"; card {card_line()}")


def h_phase(label: str, sp, witness, m: int, mul_rate, whole,
            whole_plain, zkey: bool = False, pass_other=None):
    """Each H kernel at one shape of the main path against its plain
    version, bit for bit, timed by CUDA events beside its bound and its
    plain time, twice: through its wrapper (launches back to back, paced
    by the host where a launch takes a few microseconds) and as the
    kernel alone (`alone_ms`). The row launch on the witness's standard-
    form words (its plain version reads the standard-form coefficients,
    so the card's R^2 encoding of the table is checked too) and its
    partition; the tile launch of each transform (the iNTT's, B = 3,
    with `zkey` in AB mode from the two rows; the coset NTT's, B = 3 with
    the coset powers; unless `zkey` the coset iNTT's, B = 1 in PRODUCT
    mode); each pass launch of the coset NTT (B = 3) and the coset iNTT's
    last pass with its output multiplies (B = 1); with `zkey` the
    pointwise step a.b - c, else the row table's c R^2 encoding of one
    TERM_CHUNK of its standard-form coefficients (`to_r2_words`, the
    pointwise launches of a key load). Then the whole `whole(words)`
    against `whole_plain(ints)`, its launches counted against
    `h_launches` and H_LAUNCHES, its time beside the sum of their bounds
    (this design's least time) and the function's bound
    (`h_function_work`); with `pass_other` (phase 4's coset NTT tile
    output) the pass launches at both shapes in turns. A pass works in
    place, so each timed call gets its own copy, made before the timing.
    Returns per-kernel rows (error, kernel-alone ms, plain ms, bound ms,
    bound by) for the report and the coset NTT tile's output."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.ff.fp import FR_CTX
    from infimum_tpu_torch.groth16 import rowval as RV
    from infimum_tpu_torch.ntt import ntt as N

    dev = N.device_key("cuda")
    logm = m.bit_length() - 1
    plan = N.pass_plan(logm)
    ww = RV.ints_to_words(witness, "cuda")
    nv = len(witness)
    rows = {}

    def held(name, fn, plain, work, reps=10):
        ms, got = cuda_ms(fn, reps, warm=1)
        alone, enqueue, spin = alone_ms(fn, reps)
        plain_ms, want = cuda_ms(plain, 1)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: {name} differs from its plain "
                                 f"version")
        least = bound(work[0], work[1], mul_rate)
        log(f"[h {label}] {name}: kernel alone {alone:.4f} ms (through its "
            f"wrapper {ms:.4f} ms; {reps} calls enqueued in {enqueue:.3f} "
            f"ms behind a {spin:.3f} ms spin), plain {plain_ms:.3f} ms, "
            f"bound {least[0]:.4f} ms ({least[1]}; {work[0]} bytes, "
            f"{work[1]} Fr products), {least[0] / alone:.1%} of bound; "
            f"equal to plain (max abs err 0)")
        rows.setdefault(name, (0, alone, plain_ms, *least))
        return got

    def copies(x, reps=10):
        return iter([x.clone() for _ in range(2 * reps + 2)])

    ab_rows = held("fr_rows", lambda: RV.rows_words(sp, ww, m),
                   lambda: RV.rows_plain(sp, ww, m),
                   rows_work(sp, m, nv), reps=3)
    row_partition_line(label, sp, m)
    g = N._root_of_unity(2 * m) if zkey else 5       # groth16.COSET_GEN
    tw, _ = N.word_tables(logm, False, dev)
    twi, _ = N.word_tables(logm, True, dev)
    pre = N.coset_words(logm, g, False, dev)
    inv_post = (None, None) if plan else (N.fr_const(N.fr_inv(m), dev), None)
    z_inv = N.fr_inv((pow(g, m, N.FR_MOD) - 1) % N.FR_MOD)
    h_post = (N.fr_const(z_inv * N.fr_inv(m), dev, mont=False),
              N.coset_words(logm, g, True, dev))
    if zkey:
        abc = held("fr_ntt_tile (iNTT of a, b and a.b, AB mode, B = 3)",
                   lambda: N.ntt_tile(ab_rows, logm, twi, None, *inv_post,
                                      mode=N.AB),
                   lambda: N.ntt_tile_plain(ab_rows, logm, twi, None,
                                            *inv_post, mode=N.AB),
                   tile_work(3, logm, False, 0 if plan else 1, N.AB))
    else:
        abc = ab_rows
        held("fr_ntt_tile (iNTT, B = 3)",
             lambda: N.ntt_tile(abc, logm, twi, None, *inv_post),
             lambda: N.ntt_tile_plain(abc, logm, twi, None, *inv_post),
             tile_work(3, logm, False, 0 if plan else 1))
    tiled = held("fr_ntt_tile", lambda: N.ntt_tile(abc, logm, tw, pre),
                 lambda: N.ntt_tile_plain(abc, logm, tw, pre),
                 tile_work(3, logm, True, 0))
    if not zkey:
        last = (None, None) if plan else h_post
        held("fr_ntt_tile (coset iNTT of a.b - c, PRODUCT mode, B = 1)",
             lambda: N.ntt_tile(tiled, logm, twi, None, *last,
                                mode=N.PRODUCT),
             lambda: N.ntt_tile_plain(tiled, logm, twi, None, *last,
                                      mode=N.PRODUCT),
             tile_work(1, logm, False, 0 if plan else 2, N.PRODUCT))
    x = tiled
    for i, (s0, s1) in enumerate(plan):
        fresh = copies(x)
        x = held(f"fr_ntt_pass{'' if i == 0 else f' {s0}-{s1}'}",
                 lambda: N.ntt_pass(next(fresh), logm, s0, s1, tw),
                 lambda: N.ntt_pass_plain(x, logm, s0, s1, tw),
                 pass_work(3, logm, s0, s1, 0))
    if plan:
        s0, s1 = plan[-1]
        one = tiled[:1].contiguous()
        fresh = copies(one)
        held(f"fr_ntt_pass (stages {s0}-{s1}, 2 output factors, B = 1)",
             lambda: N.ntt_pass(next(fresh), logm, s0, s1, twi, *h_post),
             lambda: N.ntt_pass_plain(one, logm, s0, s1, twi, *h_post),
             pass_work(1, logm, s0, s1, 2))
        if pass_other is not None:
            pass_turns(label, tiled, pass_other, logm, tw)
    if zkey:
        k1 = N.fr_const(1, dev, mont=False)
        held("fr_pointwise (a.b - c, x 1)",
             lambda: N.pointwise(tiled[0], tiled[1], tiled[2], k=k1),
             lambda: N.pointwise_plain(tiled[0], tiled[1], tiled[2], k=k1),
             pointwise_work(m, True, True, True))
    else:
        chunk = sp.coeffs_std[:RV.TERM_CHUNK].cuda()
        r3 = N.fr_const(FR_CTX.R2 * FR_CTX.R, dev, mont=False)
        held("fr_pointwise", lambda: RV.to_r2_words(chunk),
             lambda: N.pointwise_plain(chunk, k=r3),
             pointwise_work(chunk.shape[0], False, False, True))

    # the whole pipeline, its launches and its time
    kernels.reset_counts()
    whole(ww)
    torch.cuda.synchronize()
    counted = {k: kernels.launch_counts()[k] for k in H_KERNELS}
    launches = h_launches(sp, m, nv, zkey)
    want = {k: sum(1 for name, *_ in launches if name == k)
            for k in H_KERNELS}
    if counted != want or len(launches) != H_LAUNCHES[label]:
        raise AssertionError(f"{label}: launches {counted}, planned {want}, "
                             f"want {H_LAUNCHES[label]} in all")
    ms, got = cuda_ms(lambda: whole(ww), 3, warm=1)
    plain_ms, want_out = cuda_ms(lambda: whole_plain(witness), 1)
    if not torch.equal(got, want_out):
        raise AssertionError(f"{label}: the whole pipeline differs from "
                             f"its plain version")
    total = sum(bound(b, p, mul_rate)[0] for _, b, p in launches)
    moved = sum(b for _, b, _ in launches)
    fn_work = h_function_work(sp, m, nv, zkey)
    fn_least = bound(*fn_work, mul_rate)
    log(f"[h {label}] whole: {len(launches)} launches "
        f"({json.dumps(counted)}), kernels {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; this design's least time (the sum of its "
        f"launches' bounds) {total:.4f} ms ({moved} bytes), {total / ms:.1%} "
        f"of it; the function's bound {fn_least[0]:.4f} ms ({fn_least[1]}; "
        f"{fn_work[0]} bytes, {fn_work[1]} Fr products), "
        f"{fn_least[0] / ms:.1%} of it; equal to plain bit for bit; "
        f"{sp.nnz} terms over {sp.nmat} matrices "
        f"({', '.join(str(int(x)) for x in matrix_nnz(sp))}), longest row "
        f"{sp.longest}; tile 2^{min(logm, N.TILE_LOG)}, passes {plan}; card "
        f"{card_line()}")
    return rows, tiled


def two_pass_transform(mul_rate) -> None:
    """A coset iNTT of 2^20 values (B = 1, 1/n and the inverse coset
    powers as output factors): one tile launch and two pass launches,
    each launch and the whole `ntt_words` equal to the plain tile and
    passes on the card, timed beside the sum of its launches' bounds."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.ff.fp import limbs_to_words
    from infimum_tpu_torch.ntt import ntt as N

    logn, dev = 20, N.device_key("cuda")
    n = 1 << logn
    plan = N.pass_plan(logn)
    if len(plan) != 2:
        raise AssertionError(f"2^{logn}: pass plan {plan}, want two passes")
    x = limbs_to_words(_random_fr(np.random.default_rng(H_SEED + logn),
                                  n)).unsqueeze(0).cuda()
    tw, _ = N.word_tables(logn, True, dev)
    post = (N.fr_const(N.fr_inv(n), dev), N.coset_words(logn, 5, True, dev))
    kernels.reset_counts()
    got = N.ntt_words(x, logn, True, None, *post)
    torch.cuda.synchronize()
    counts = {k: kernels.launch_counts()[k] for k in H_KERNELS}
    if counts != {"fr_rows": 0, "fr_ntt_tile": 1, "fr_ntt_pass": 2,
                  "fr_pointwise": 0}:
        raise AssertionError(f"2^{logn}: launches {counts}")
    ms, _ = cuda_ms(lambda: N.ntt_words(x, logn, True, None, *post), 3,
                    warm=1)
    want = N.ntt_tile_plain(x, logn, tw)
    if not torch.equal(N.ntt_tile(x, logn, tw), want):
        raise AssertionError(f"2^{logn}: the tile differs from plain")
    work = [tile_work(1, logn, False, 0)]
    for s0, s1 in plan:
        last = post if s1 == logn else (None, None)
        step = N.ntt_pass(want.clone(), logn, s0, s1, tw, *last)
        want = N.ntt_pass_plain(want, logn, s0, s1, tw, *last)
        if not torch.equal(step, want):
            raise AssertionError(f"2^{logn}: pass {s0}-{s1} differs from "
                                 f"plain")
        work.append(pass_work(1, logn, s0, s1, 2 if s1 == logn else 0))
    if not torch.equal(got, want):
        raise AssertionError(f"2^{logn}: ntt_words differs from plain")
    least = sum(bound(b, p, mul_rate)[0] for b, p in work)
    log(f"[h 2^{logn}] coset iNTT, B = 1, tile and passes {plan}: each "
        f"launch and the whole equal to plain (max abs err 0); kernels "
        f"{ms:.4f} ms, the launches' bounds {least:.4f} ms "
        f"({least / ms:.1%}); card {card_line()}")


def matrix_nnz(sp):
    """Terms of each matrix of `sp`, from its row pointer."""
    ends = sp.rowptr[::sp.num_rows].tolist() if sp.num_rows else [0]
    return [b - a for a, b in zip(ends, ends[1:])]


def _random_witness(n: int, seed: int) -> list[int]:
    """n field elements below 2^253 from a numpy seed: an input for the
    kernels at a circuit's shape (not a satisfying witness)."""
    from infimum_tpu_torch.ff.fp import tensor_to_ints

    return tensor_to_ints(_random_fr(np.random.default_rng(seed), n))


def h_kernels(run, mul_rate) -> dict:
    """Phase 4's H part: the process circuit's shape (2^18, B = 3) with
    the first process witness, then the tally circuit's (2^14) with a
    witness from a seed; each through `h_phase`, after the H kernels'
    resources; then a two-pass transform (`two_pass_transform`). Returns
    the process shape's rows and its coset NTT tile's output."""
    from infimum_tpu_torch.groth16 import groth16 as g16

    h_resources()
    out = {}, None
    for label, circuit, witness in (
            ("process", run.keys.process_circuit,
             run.first_process["witness"]),
            ("tally", run.keys.tally_circuit,
             _random_witness(run.keys.tally_circuit.cs.num_vars,
                             H_SEED))):
        cs = circuit.cs
        rows, tiled = h_phase(label, g16.sparse_rows(cs, "cuda"), witness,
                              g16._domain_size(cs), mul_rate,
                              lambda ww, cs=cs: g16.h_rows(cs, ww, "cuda"),
                              lambda w, cs=cs: g16.h_rows_plain(cs, w,
                                                                "cuda"))
        if label == "process":
            out = rows, tiled
    two_pass_transform(mul_rate)
    return out


def prove_launches(pk, cs, witness) -> dict:
    """Every kernel's launches in one steady prove(): the H stage's must be
    its plan's (`h_launches`: no pointwise launch), the MSMs' all there."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.groth16 import groth16 as g16

    from infimum_tpu_torch.msm import msm as M

    fed, real = [], (M.layout_recode, M.padded_limbs)

    def recode(sc, *a, **k):
        fed.append((sc.dtype, tuple(sc.shape)))
        return real[0](sc, *a, **k)

    def padded(*a, **k):
        fed.append("padded_limbs")
        return real[1](*a, **k)

    M.layout_recode, M.padded_limbs = recode, padded
    try:
        kernels.reset_counts()
        g16.prove(pk, cs, witness, device="cuda")
        torch.cuda.synchronize()
    finally:
        M.layout_recode, M.padded_limbs = real
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    if len(fed) != 5 or any(f == "padded_limbs" or f[0] != torch.int32
                            or f[1][1] != 8 for f in fed):
        raise AssertionError(f"a steady prove() fed its recodes {fed}, want "
                             f"five (n, 8) int32 words and no padded copy")
    plan = h_launches(g16.sparse_rows(cs, "cuda"), g16._domain_size(cs),
                      len(witness), False)
    want = {k: sum(1 for name, *_ in plan if name == k) for k in H_KERNELS}
    got = {k: counts.get(k, 0) for k in H_KERNELS}
    if got != want or want["fr_pointwise"]:
        raise AssertionError(f"a steady prove()'s H launches {got}, want "
                             f"{want}")
    missing = [k for k in MSM_KERNELS if not counts.get(k)]
    if missing:
        raise AssertionError(f"a steady prove() never launched {missing}")
    # each MSM launches every stage of its curve once: its recode (the
    # scan in the same launch) fed the prove's words as they are, no
    # padded or limb copy of them made
    for curve in ("g1", "g2"):
        stages = {k: counts[k] for k in MSM_KERNELS if k.endswith(curve)}
        if len(set(stages.values())) != 1:
            raise AssertionError(f"a steady prove()'s {curve} MSM launches "
                                 f"differ: {stages}")
    log(f"[prove] launches of one steady process prove(): "
        f"{json.dumps(counts)} (no fr_pointwise: the witness is not "
        f"encoded); its recodes fed {fed} (words, no padded copy)")
    return counts


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
    largest error against plain, {arity: (depth, the padded leaves, the
    native root)} of the two trees)."""
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
    reg_leaves = [zeros2] + signup_leaves
    trees = {2: (10, reg_leaves + [zeros2] * (1024 - len(reg_leaves)),
                 reg.root),
             5: (6, msg_leaves + [zeros5] * (5 ** 6 - len(msg_leaves)),
                 msg.root)}
    return launches, err, trees


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
    from infimum_tpu_torch import kernels

    if len(timings["kernel_load_log"]) != len(kernels.SOURCES):
        raise AssertionError("kernel_load_log wants one entry a source")


def cache_hit(run, cache_before: set, launches: dict, setups: int,
              seed: int = 99) -> None:
    """Phase 3: whether the e2e ran setup (`setups`, its calls: a
    key-cache miss writes keys), and then that each fixed-base instance
    launched once a setup in the e2e (`launches`); then `setup_cached` for
    the process circuit with the e2e's seed must load the key the e2e
    cached (setup is not run), and a proof from the loaded key must
    verify."""
    from infimum_tpu_torch.groth16 import groth16 as g16, pkcache

    written = sorted(set(os.listdir(pkcache.default_cache_dir()))
                     - cache_before)
    fixed = {k: launches[k] for k in FIXED_BASE_KERNELS}
    if fixed != dict.fromkeys(FIXED_BASE_KERNELS, setups):
        raise AssertionError(f"{setups} setup calls but the fixed-base "
                             f"kernels launched {fixed}")
    ran = f"ran {setups} times (a miss)" if setups else "did not run (a hit)"
    log(f"[pkcache] setup {ran}: fixed-base launches {fixed}; setup_process "
        f"{run.timings['setup_process']}s; card {card_line()}")
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
    idle = [k for k, n in launches.items()
            if n == 0 and k.startswith(("msm_", "fr_"))]
    if idle:
        raise AssertionError(f"kernels never launched in phase 8: {idle}")
    log(f"[scale] {n_p} + {n_t} commitments walked through the pallet's "
        f"prepare_public_inputs; {len(verified)} sampled proofs verified by "
        f"the native pairing; kernel launches {launches}; card {card_line()}")
    pk, cs, witness = sampled[0]
    kernel_vs_plain(pk, cs, witness, mul_rate, tag="scale ")


# -- the fixed-base multiply of setup and zkey generation (phases 3 and 9) ----

FIXED_BASE_KERNELS = ("fixed_base_g1", "fixed_base_g2")
FIXED_HOST = 1024           # decoded points a curve against the host multiply
# Fq products a point of the fixed base's affine epilogue, in the function's
# yardstick: 3 for the batched inversion's product tree, then the
# coordinates' (G1: x, y; G2: the norm's 2, conj(Z) / d's 2, x and y as Fq2
# products, 2 x 3). The tree's leaves come out as standard-form 1 / d, so
# those products leave Montgomery form at once and none is spent on that.
# And one inversion a block of GROUP points: the almost inverse's one
# Montgomery product (the rest of it is subtractions and shifts)
FIXED_EPILOGUE_MULS = {"g1": 3 + 2, "g2": 3 + 2 + 2 + 2 * 3}
INVERSION_MULS = 1
# the field types in the kernels' mangled names (nvcc's resource report)
FIXED_FIELD = {"g1": "11FqTwoChains", "g2": "12Fq2TwoChains"}


class FixedBaseSplit:
    """Within `with`, the program's `fixed_base_mul_batch` runs as it is,
    with a clock around each of the three steps it calls in
    `msm/fixed_base.py`: the scalars' encoding (`ints_to_words`, host
    clock, synced), the device part (`mul_words`, CUDA events, synced
    before and after; the window table built before the events, once per
    curve and card) and the decode (`decode_words`, host). Each call's
    record keeps its scalars and their words for the checks after it."""

    def __init__(self):
        self.calls = []

    def _encode(self, scalars, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = self._real["ints_to_words"](scalars, device)
        torch.cuda.synchronize()
        self.calls.append({"n": len(scalars), "encode_s":
                           time.perf_counter() - t0, "t0": t0,
                           "scalars": scalars, "sc": sc})
        return sc

    def _mul(self, sc, curve, c):
        from infimum_tpu_torch.ff.fp import device_key
        from infimum_tpu_torch.msm import fixed_base as fb

        fb.table_words(curve.name, device_key(sc.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._real["mul_words"](sc, curve, c)
        end.record()
        torch.cuda.synchronize()
        self.calls[-1].update(curve=curve.name,
                              device_ms=start.elapsed_time(end))
        return out

    def _decode(self, out, curve):
        t0 = time.perf_counter()
        pts = self._real["decode_words"](out, curve)
        t1 = time.perf_counter()
        call = self.calls[-1]
        call.update(decode_s=t1 - t0, whole_s=t1 - call["t0"])
        return pts

    def __enter__(self):
        from infimum_tpu_torch.msm import fixed_base as fb

        self._real = {k: getattr(fb, k) for k in
                      ("ints_to_words", "mul_words", "decode_words")}
        fb.ints_to_words, fb.mul_words, fb.decode_words = (
            self._encode, self._mul, self._decode)
        return self

    def __exit__(self, *exc):
        from infimum_tpu_torch.msm import fixed_base as fb

        for k, f in self._real.items():
            setattr(fb, k, f)

    def lines(self) -> list[str]:
        return [f"{c['curve'].upper()} {c['n']} scalars: encoding "
                f"{c['encode_s']:.3f} s, device {c['device_ms']:.3f} ms, "
                f"decode {c['decode_s']:.3f} s (call {c['whole_s']:.3f} s)"
                for c in self.calls]


def fixed_base_kernels(split: FixedBaseSplit, mul_rate) -> dict:
    """Phase 9: each fixed-base call of `generate_zkey` held against the
    plain version (`mul_words_plain`: `_mul_chunk` over chunks of 2^17,
    then `normalize_plain`) bit for bit on the card over every scalar of
    the call, the plain version timed once at that full shape; FIXED_HOST
    decoded points a curve, spread over the list, against the host
    multiply; the kernel alone at the full shape beside its bound (the
    mixed adds this run's digits need, with and without the affine
    epilogue's products and inversions), its registers, resident blocks
    and waves. Returns the report's rows."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.curve.bn254_host import fixed_base_mul_host
    from infimum_tpu_torch.curve.proj import CURVES
    from infimum_tpu_torch.ff.fp import device_key
    from infimum_tpu_torch.msm import fixed_base as fb

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for call in split.calls:
        name, sc, n = call["curve"], call["sc"], call["n"]
        curve = CURVES[name]
        torch.cuda.synchronize()
        plain_ms, plain = cuda_ms(lambda: fb.mul_words_plain(sc, curve), 1)
        if not torch.equal(fb.mul_words(sc, curve), plain):
            raise AssertionError(f"fixed_base_{name}: kernel and plain "
                                 f"differ over the call's {n} scalars")
        del plain
        pick = np.linspace(0, n - 1, FIXED_HOST).round().astype(int)
        got = fb.decode_words(fb.mul_words(sc[torch.from_numpy(pick).to(
            sc.device)].contiguous(), curve), curve)
        want = fixed_base_mul_host([call["scalars"][i] for i in pick], name)
        if got != want:
            raise AssertionError(f"fixed_base_{name}: decoded points differ "
                                 f"from the host multiply")
        ms, enqueue, _ = alone_ms(lambda: fb.mul_words(sc, curve), 10)
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        adds = int((sc.view(torch.uint8) != 0).sum())      # a digit a byte
        out_bytes = n * 2 * 4 * (8 if name == "g1" else 16)
        table = fb.table_words(name, device_key(sc.device))
        groups = -(-n // fb.GROUP)
        loop = bound(nbytes(sc, table) + out_bytes, adds * MIXED_MULS[name],
                     mul_rate)
        bnd = bound(nbytes(sc, table) + out_bytes,
                    adds * MIXED_MULS[name] + n * FIXED_EPILOGUE_MULS[name]
                    + groups * INVERSION_MULS, mul_rate)
        usage = kernel_resources("fixed_base_kernel", FIXED_FIELD[name])
        blocks = kernels.fixed_base_blocks_per_sm(name)
        waves = n / (blocks * fb.GROUP * sms)
        rows[f"fixed_base_{name}"] = (0, ms, plain_ms, *bnd, None)
        log(f"[zkey] fixed_base_{name}: {n} scalars, {adds} mixed adds "
            f"(nonzero digits), {groups} inversions; bit-equal to plain "
            f"over all {n} scalars (affine standard-form words); "
            f"{FIXED_HOST} decoded points equal to fixed_base_mul_host; "
            f"kernel alone {ms:.3f} ms (enqueue {enqueue:.3f} ms; SM clock, "
            f"power, temperature just after: {clocks}) against "
            f"bound {bnd[0]:.3f} ms ({bnd[1]}, {bnd[0] / ms:.1%}; the "
            f"main loop's alone {loop[0]:.3f} ms, {loop[0] / ms:.1%}); "
            f"{usage}, {blocks} blocks of {fb.GROUP} an SM, {waves:.2f} "
            f"waves; plain (_mul_chunk over chunks of {fb.CHUNK}, then "
            f"normalize_plain) {plain_ms:.1f} ms at the full shape; card "
            f"{card_line()}")
    return rows


def zkey_phase(run, mul_rate, pass_input):
    """Phase 9: the process circuit's zkey generated on the card (each
    fixed-base call split into encoding, device part and decode; one
    launch of each fixed-base instance), written
    to a file and read back (every field equal), two `prove_zkey` calls of
    the e2e's first process witness from the read zkey (the first encodes
    its queries), each proof verified by the native pairing and through
    the arkworks bytes, a tampered proof and a wrong public input
    rejected, all four MSM kernel instances launched; three steady
    `prove()` and `prove_zkey` calls of that witness in turns, with their
    stage traces; then each MSM kernel held against its plain version at
    the zkey's `h` shape, the H kernels at its odd coset (`h_phase`,
    the pass launches in turns with phase 4's `pass_input`), and the
    fixed-base kernels (`fixed_base_kernels`). Returns their report rows
    and `generate_zkey`'s fixed-base launches."""
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
    kernels.reset_counts()
    with FixedBaseSplit() as split:
        t0 = time.perf_counter()
        zk = Z.generate_zkey(cs, random.Random(ZKEY_SEED), device="cuda")
        gen_s = time.perf_counter() - t0
    gen_launches = {k: kernels.KERNELS[k].launches for k in FIXED_BASE_KERNELS}
    if gen_launches != dict.fromkeys(FIXED_BASE_KERNELS, 1) or \
            [c["curve"] for c in split.calls] != ["g1", "g2"]:
        raise AssertionError(f"generate_zkey launched {gen_launches} for "
                             f"calls {[c['curve'] for c in split.calls]}")
    log(f"[zkey] generate_zkey {gen_s:.3f}s: fixed-base launches "
        f"{gen_launches}; " + "; ".join(split.lines())
        + f"; card {card_line()}")
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
    idle = [k for k, n in launches.items()
            if n == 0 and k.startswith(("msm_", "fr_"))]
    if idle:
        raise AssertionError(f"kernels never launched in phase 9: {idle}")
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

    p_odd = Z.odd_coset_words(back, witness, "cuda")
    msm_kernels("h", G1_DEV, *g16._msm_inputs(back, "h", back.h_query, p_odd,
                                              G1_DEV),
                mul_rate, tag="zkey ", compare=True)
    h_phase("zkey", Z.zkey_rows(back, "cuda"), witness, back.domain_size,
            mul_rate, lambda ww: Z.odd_coset_rows(back, ww, "cuda"),
            lambda w: Z.odd_coset_rows_plain(back, w, "cuda"), zkey=True,
            pass_other=pass_input)
    return fixed_base_kernels(split, mul_rate), gen_launches


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
            # the e2e's keys: their row tables are encoded already, and a
            # prove launches no pointwise step
            idle = [k for k, n in launches.items() if n == 0 and k.startswith(
                ("msm_", "fr_rows", "fr_ntt_"))]
            if idle or launches["fr_pointwise"]:
                raise AssertionError(f"kernels idle in phase 10: {idle}; "
                                     f"pointwise launches "
                                     f"{launches['fr_pointwise']}, want 0")
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


# -- phase 11: the multi-GPU slice ------------------------------------------------

MULTI_SEED = 20260822
WEAK_ROWS = 1 << 18              # the process key's h query
NTT_LOGN = 18                    # the process circuit's domain
MSM_CASES = (                    # (case, input set, rows a rank: None = shard)
    ("weak", "h", WEAK_ROWS), ("strong", "h", None),
    ("g1_2^20", "g1_2^20", None), ("g2_b2", "b2", None))
MULTI_REPS = 3


def _random_fr(rng, n: int) -> torch.Tensor:
    """(n, 16) int64 limbs of values below 2^253 < r, from numpy's `rng`."""
    limbs = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
    limbs[:, 15] &= (1 << 13) - 1
    return torch.from_numpy(limbs)


def multi_inputs(run, trees, tmp: str):
    """Phase 11's inputs as files of 32-bit words under `tmp`, and their
    one-card results: {set: (curve, rows file, scalars file, rows)} for the
    MSMs (the process key's `h` query with the first witness's H scalars;
    those rows tiled to 2^20 with scalars from a seed, zero at the zero
    rows that pad the query; the `b2` query with the witness), the NTT's
    input and one-card output, and the poll's trees. The expected points
    are the one-card `msm_rows_async` + `combine_window_points` of the
    same rows; `want["wins", set]` keeps their window sums as words."""
    from infimum_tpu_torch.ff.fp import FR_CTX, limbs_to_words, words_to_limbs
    from infimum_tpu_torch.msm import msm as M
    from infimum_tpu_torch.ntt.ntt import ntt

    def save(name, t):              # limbs, or a query's table as words
        path = os.path.join(tmp, f"{name}.npy")
        words = t if t.dtype == torch.int32 else limbs_to_words(t)
        np.save(path, words.cpu().numpy())
        return path

    q = {name: (curve.name, rows, M.padded_limbs(sc, rows.shape[0], mask))
         for name, curve, rows, sc, mask, _ in
         query_inputs(run.keys.process_pk, run.keys.process_circuit.cs,
                      run.first_process["witness"]) if name in ("h", "b2")}
    rng = np.random.default_rng(MULTI_SEED)
    h_rows = q["h"][1]
    if h_rows.shape[0] != WEAK_ROWS:
        raise AssertionError(f"h query has {h_rows.shape[0]} rows")
    # the query's zero rows pad it to its lanes: they keep zero scalars
    tiled = h_rows.repeat(4, 1)
    fresh = _random_fr(rng, 4 * WEAK_ROWS).cuda()
    q["g1_2^20"] = ("g1", tiled, torch.where(
        (tiled == 0).all(1, keepdim=True), 0, fresh))
    files, want = {}, {}
    t0 = time.perf_counter()
    for name, (curve, rows, sc) in q.items():
        files[name] = (curve, save(f"{name}_rows", rows),
                       save(f"{name}_sc", sc), rows.shape[0])
        lanes = M.msm_lanes(rows.shape[0], curve)
        want["wins", name] = M.msm_rows_words(rows, sc, lanes, curve)
        want[name] = M.combine_window_points(
            words_to_limbs(want["wins", name]).cpu(), curve)
    a = _random_fr(rng, 1 << NTT_LOGN).cuda()      # Montgomery values < r
    files["ntt"] = (save("ntt_in", a), save("ntt_out", ntt(a, NTT_LOGN)))
    for arity, (depth, leaves, root) in trees.items():
        files["tree", arity] = (depth, save(f"tree{arity}",
                                            FR_CTX.encode(leaves, "cuda")))
        want["tree", arity] = root
    torch.cuda.synchronize()
    log(f"[multi] inputs written and one-card results in "
        f"{time.perf_counter() - t0:.1f}s: h {WEAK_ROWS} G1 rows, 2^20 G1 "
        f"rows (h tiled, scalars from seed {MULTI_SEED}), b2 "
        f"{q['b2'][1].shape[0]} G2 rows, NTT 2^{NTT_LOGN}, trees (2, 10) "
        f"and (5, 6)")
    return files, want


def _load_words(path, sl, device) -> torch.Tensor:
    """Rows `sl` of a words file, as limbs on `device`."""
    from infimum_tpu_torch.ff.fp import words_to_limbs

    rows = np.load(path, mmap_mode="r")[sl]
    return words_to_limbs(torch.from_numpy(np.array(rows)).to(device))


def _timed(mesh, fn):
    """(median CUDA-event ms of MULTI_REPS runs of fn() after one warm run,
    each begun by a barrier of the group; the last result; the bytes the
    collectives sent and received in one run)."""
    from infimum_tpu_torch.parallel import distributed as D

    times = []
    mesh.sent = mesh.received = 0
    for i in range(MULTI_REPS + 1):
        D.barrier(mesh)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(mesh.device)
        if i:
            times.append(start.elapsed_time(end))
    runs = MULTI_REPS + 1
    return (sorted(times)[len(times) // 2], out, mesh.sent // runs,
            mesh.received // runs)


def multi_rank(mesh, files, work) -> dict:
    """One rank of a phase-11 world: its shard of every case of `work`
    through the port's sharded MSM (both reductions), NTT and trees on its
    card, with its launch counts from just before to just after."""
    from infimum_tpu_torch import kernels
    from infimum_tpu_torch.ff.fp import FR_CTX, limbs_to_words
    from infimum_tpu_torch.msm.msm import (
        combine_window_points, msm_lanes, msm_rows_words,
    )
    from infimum_tpu_torch.parallel import distributed as D
    from infimum_tpu_torch.parallel import msm as PM
    from infimum_tpu_torch.parallel import ntt as PN
    from infimum_tpu_torch.parallel import tree as PT

    kernels.library()
    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev),
           "card": torch.cuda.get_device_name(dev), "msm": {}, "tree": {},
           "sum": {}}
    # (case, curve, rows' file, scalars' file, shard, the gather's sum)
    sums = []
    kernels.reset_counts()
    if work["msm"]:
        for case, name, per_rank in MSM_CASES:
            curve, rows_f, sc_f, n = files[name]
            if per_rank:                 # weak: the set once a rank
                sl = slice(0, per_rank)
            else:
                sl = D.host_shard(n, mesh)
            rows, sc = _load_words(rows_f, sl, dev), _load_words(sc_f, sl,
                                                                  dev)
            for mode in ("gather", "permute"):
                fn = PM.make_sharded_window_sums(mesh, curve, reduce=mode)
                ms, wins, sent, got = _timed(mesh, lambda: fn(rows, sc))
                point = (None if wins is None
                         else combine_window_points(wins.cpu(), curve))
                out["msm"][case, mode] = (ms, wins is not None, point, sent,
                                          got)
                if mode == "gather":
                    summed = limbs_to_words(wins)
            sums.append((case, curve, rows_f, sc_f, sl, summed))
            del rows, sc
    if work["ntt"]:
        fwd, logn2, logn1 = PN.make_ntt_sharded(mesh, NTT_LOGN)
        inv = PN.make_intt_sharded(mesh, NTT_LOGN)
        in_f, out_f = files["ntt"]
        n2, n1 = 1 << logn2, 1 << logn1
        cols = D.host_shard(n1, mesh)
        rows = D.host_shard(n2, mesh)
        a_l = _load_words(in_f, slice(None), dev).reshape(n2, n1, 16)[:, cols]
        want = _load_words(out_f, slice(None), dev).reshape(n1, n2, 16)[
            :, rows].transpose(0, 1)
        fwd_ms, d_l, _, _ = _timed(mesh, lambda: fwd(a_l))
        inv_ms, back, _, _ = _timed(mesh, lambda: inv(d_l))
        out["ntt"] = (fwd_ms, inv_ms, bool(torch.equal(d_l, want)),
                      bool(torch.equal(back, a_l)))
    for arity in work["tree"]:
        depth, leaves_f = files["tree", arity]
        leaves = _load_words(leaves_f, D.host_shard(arity ** depth, mesh),
                             dev)
        build = PT.make_tree_builder(mesh, arity, depth)
        ms, root, _, _ = _timed(mesh, lambda: build(leaves))
        out["tree"][arity] = (ms, FR_CTX.decode(root)[0])
    torch.cuda.synchronize(dev)
    out["launches"] = kernels.launch_counts()
    # after the counts: every rank's window sums gathered again (each rank
    # runs this, so the collective stays matched), the sum kernel against
    # its plain version on them, and one permute round (mine plus a
    # partner's window sums) timed both ways: the plain version is the old
    # round (limbs, one complete add in torch, words)
    gathered = []
    for case, curve, rows_f, sc_f, sl, summed in sums:
        rows, sc = _load_words(rows_f, sl, dev), _load_words(sc_f, sl, dev)
        lanes = msm_lanes(rows.shape[0], curve)
        every = D.all_gather(msm_rows_words(*PM._pad(rows, sc, lanes), lanes,
                                            curve), mesh)
        gathered.append((curve, every))
        kern = PM.point_sum(every, curve)
        out["sum"][case] = (bool(torch.equal(kern, PM.point_sum_plain(
            every, curve))), bool(torch.equal(kern, summed)))
    for curve in ("g1", "g2") if sums else ():
        every = next(e for c, e in gathered if c == curve)
        pair = torch.stack([every[0], every[-1]])
        out["add_ms", curve] = tuple(
            cuda_ms(lambda: f(pair, curve), MULTI_REPS, warm=1)[0]
            for f in (PM.point_sum_plain, PM.point_sum))
    out["foreign"] = foreign_modules()
    return out


SUM_DS = (2, 4, 8)


def sum_kernels(want, mul_rate) -> dict:
    """Phase 11 on one card: the sum kernel alone on D = 2, 4 and 8 points
    a window (the one-card MSM's window sums of `h` for G1 and `b2` for
    G2, entry i rolled by i windows), each equal to its plain version bit
    for bit, beside its bound (T - 1 complete adds a window) and the plain
    version's time. Returns the report's rows at D = 2 (a permute
    round)."""
    from infimum_tpu_torch.msm.msm import SPECS
    from infimum_tpu_torch.parallel import msm as PM

    rows, lines = {}, []
    for curve, name in (("g1", "h"), ("g2", "b2")):
        spec = SPECS[curve]
        wins = want["wins", name]
        for d in SUM_DS:
            every = torch.stack([wins.roll(i, 0) for i in range(d)])
            got = PM.point_sum(every, curve)
            if not torch.equal(got, PM.point_sum_plain(every, curve)):
                raise AssertionError(f"point_sum_{curve} at D = {d} differs "
                                     f"from plain")
            ms, _, _ = alone_ms(lambda: PM.point_sum(every, curve), 20)
            plain_ms, _ = cuda_ms(lambda: PM.point_sum_plain(every, curve),
                                  MULTI_REPS, warm=1)
            adds = ((1 << (d - 1).bit_length()) - 1) * spec.n_windows
            bnd = bound(nbytes(every, got), adds * ADD_MULS[curve], mul_rate)
            if d == 2:
                rows[f"point_sum_{curve}"] = (0, ms, plain_ms, *bnd, None)
            lines.append(f"{curve.upper()} D = {d}: kernel {ms:.4f} ms, "
                         f"bound {bnd[0]:.6f} ms ({bnd[1]}, {adds} adds), "
                         f"plain {plain_ms:.3f} ms")
    log(f"[multi] the sum kernel alone, bit-equal to plain: "
        + "; ".join(lines) + f"; card {card_line()}")
    return rows


def twiddle_kernel(mul_rate) -> None:
    """Phase 11 on one card: the sharded NTT's twiddle product, one
    pointwise launch over rank 0's slab of the 2^18 transform at D = 1, 2
    and 4 ((N1/D, N2) words, values from a seed, times the cached twiddle
    words), equal to its plain version bit for bit, alone beside its bound
    (both operands read and the product written once; a product a value)
    and the plain version's time."""
    from infimum_tpu_torch.ff.fp import limbs_to_words
    from infimum_tpu_torch.ntt.ntt import pointwise, pointwise_plain
    from infimum_tpu_torch.parallel import distributed as D
    from infimum_tpu_torch.parallel import ntt as PN

    rng = np.random.default_rng(MULTI_SEED + 1)
    lines = []
    for d in (1, 2, 4):
        mesh = D.ProvingMesh(0, d, torch.device("cuda", 0))
        logn2, logn1 = PN._split(NTT_LOGN, d)
        tw = PN._twiddles(mesh, logn2, logn1, False)
        x = limbs_to_words(_random_fr(rng, tw.numel() // 8).cuda()).reshape(
            tw.shape)
        got = pointwise(x, tw)
        if not torch.equal(got, pointwise_plain(x, tw)):
            raise AssertionError(f"the twiddle product at D = {d} differs "
                                 f"from plain")
        ms, _, _ = alone_ms(lambda: pointwise(x, tw), 20)
        plain_ms, _ = cuda_ms(lambda: pointwise_plain(x, tw), MULTI_REPS,
                              warm=1)
        bnd = bound(nbytes(x, tw, got), x.numel() // 8, mul_rate)
        lines.append(f"D = {d}: {tuple(x.shape[:2])} values, kernel "
                     f"{ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
                     f"{bnd[0] / ms:.1%}), plain {plain_ms:.3f} ms")
    log(f"[multi] the twiddle product (fr_pointwise) alone, bit-equal to "
        f"plain: " + "; ".join(lines) + f"; card {card_line()}")


def multi_worlds(cards: int):
    """(world size, backend, work) of phase 11: NCCL at D = 1; D = 2 and 4
    over NCCL where there are as many cards, else over gloo; the quinary
    tree's D = 5 over gloo. `work["tree"]` lists the trees' arities."""
    worlds = [(1, "nccl", {"msm": True, "ntt": True, "tree": [2, 5]})]
    for d in (2, 4):
        worlds.append((d, "nccl" if cards >= d else "gloo",
                       {"msm": True, "ntt": True, "tree": [2]}))
    worlds.append((5, "gloo", {"msm": False, "ntt": False, "tree": [5]}))
    return worlds


def multi_gpu_phase(run, trees, mul_rate):
    """Phase 11: the port's `parallel/` over torch.distributed, one spawned
    process a rank. Every result equal to its one-card result, every rank
    of an MSM run launching all MSM kernel instances and the sum kernel
    for each curve (equal to its plain version there), of an NTT run the
    tile and pointwise kernels, and of a tree run the Poseidon kernel, no
    JAX on any rank; the sum kernel alone at D = 2, 4, 8 (`sum_kernels`)
    and the twiddle product alone at D = 1, 2, 4 (`twiddle_kernel`);
    prints each world's backend, cards and per-rank CUDA-event ms, and the
    `msm_scaling` record. Returns the ranks' launch counts, summed, and
    the sum kernel's report rows."""
    import tempfile

    from infimum_tpu_torch.curve.proj import CURVES
    from infimum_tpu_torch.parallel import distributed as D
    from infimum_tpu_torch.parallel.msm import reduction_comm_bytes

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    summed: dict = {}
    rec = {"weak_ms_per_const_work": {}, "weak_n_per_device": WEAK_ROWS,
           "strong_ms": {}, "strong_n": WEAK_ROWS, "g1_2^20_ms": {},
           "g2_b2_ms": {}, "modes_ms": {}, "per_rank_ms": {},
           "reduction_comm": {}, "reduction_add_ms": {},
           "ntt_2^18_ms": {}, "tree_ms": {},
           "backend": {}, "cards": {}}
    with tempfile.TemporaryDirectory() as tmp:
        files, want = multi_inputs(run, trees, tmp)
        sum_rows = sum_kernels(want, mul_rate)
        twiddle_kernel(mul_rate)
        for d, backend, work in multi_worlds(cards):
            w0 = time.perf_counter()
            ranks = D.spawn(multi_rank, d, backend, "cuda", (files, work),
                            timeout_s=600)
            key = str(d)
            rec["backend"][key] = backend
            rec["cards"][key] = [r["device"] for r in ranks]
            for r in ranks:
                if r["foreign"]:
                    raise AssertionError(f"rank {r['rank']} of {d} imported "
                                         f"{r['foreign'][:5]}")
                for k, n in r["launches"].items():
                    summed[k] = summed.get(k, 0) + n
                # gather reduces on every rank, so every rank sums (a
                # launch from D = 2 on: at D = 1 the one entry is the sum)
                sum_need = list(SUM_KERNELS) if d >= 2 else []
                need = (list(MSM_KERNELS) + sum_need
                        if work["msm"] else []) + (
                    ["poseidon_perm"] if work["tree"] else []) + (
                    ["fr_ntt_tile", "fr_pointwise"] if work["ntt"] else [])
                idle = [k for k in need if r["launches"][k] == 0]
                if idle:
                    raise AssertionError(f"rank {r['rank']} of {d} never "
                                         f"launched {idle}")
                bad = {c: x for c, x in r["sum"].items() if x != (True, True)}
                if bad:
                    raise AssertionError(f"rank {r['rank']} of {d}: the sum "
                                         f"kernel against plain and the "
                                         f"gather's sum: {bad}")
            lines = []
            for case, name, per_rank in MSM_CASES if work["msm"] else ():
                curve = files[name][0]
                expect = want[name]
                if per_rank:             # every rank the same rows: d x P
                    expect = CURVES[curve].host_mul(expect, d)
                auto = reduction_comm_bytes(d, curve)["mode"]
                for mode in ("gather", "permute"):
                    res = [r["msm"][case, mode] for r in ranks]
                    holders = [r for r, x in zip(ranks, res) if x[1]]
                    if [r["rank"] for r in holders] != (
                            list(range(d)) if mode == "gather" else [0]):
                        raise AssertionError(f"{case} {mode}: held on "
                                             f"{[r['rank'] for r in holders]}")
                    if any(x[2] != expect for x in res if x[1]):
                        raise AssertionError(f"{case} {mode} over {d} ranks "
                                             f"differs from one card")
                    model = reduction_comm_bytes(d, curve, mode)
                    moved = max(x[4] for x in res)
                    if moved != model["per_device_bytes"]:
                        raise AssertionError(f"{case} {mode}: {moved} bytes "
                                             f"received, model {model}")
                    ms = [x[0] for x in res]
                    rec["modes_ms"].setdefault(case, {}).setdefault(
                        key, {})[mode] = max(ms)
                    if mode == auto:
                        rec["per_rank_ms"].setdefault(case, {})[key] = ms
                        rec[{"weak": "weak_ms_per_const_work",
                             "strong": "strong_ms"}.get(case, f"{case}_ms")
                            ][key] = max(ms)
                    lines.append(f"{case} {mode} {max(ms):.3f} ms (ranks "
                                 + " / ".join(f"{m:.3f}" for m in ms)
                                 + f"; {moved} B received)")
                rec["reduction_comm"].setdefault(key, {})[curve] = {
                    m: reduction_comm_bytes(d, curve, m)
                    for m in (("gather", "permute") if d & (d - 1) == 0
                              else ("gather",))}
            if work["msm"]:
                adds = {c: {"plain": max(r["add_ms", c][0] for r in ranks),
                            "kernel": max(r["add_ms", c][1] for r in ranks)}
                        for c in ("g1", "g2")}
                rec["reduction_add_ms"][key] = adds
                lines.append(
                    "the sum kernel equal to plain on every rank's window "
                    "sums and to the gather's sum; one permute round of "
                    "the window sums, plain (the old torch add) against "
                    "the kernel: " + ", ".join(
                        f"{c.upper()} {a['plain']:.3f} / {a['kernel']:.4f} ms"
                        for c, a in adds.items()))
            if work["ntt"]:
                res = [r["ntt"] for r in ranks]
                if not all(x[2] and x[3] for x in res):
                    raise AssertionError(f"NTT over {d} ranks: forward "
                                         f"{[x[2] for x in res]}, round trip "
                                         f"{[x[3] for x in res]}")
                rec["ntt_2^18_ms"][key] = {
                    "forward": max(x[0] for x in res),
                    "inverse": max(x[1] for x in res)}
                lines.append(f"NTT 2^{NTT_LOGN} forward "
                             f"{max(x[0] for x in res):.3f} / inverse "
                             f"{max(x[1] for x in res):.3f} ms, k-form equal "
                             f"to one card, round trip exact")
            for arity in work["tree"]:
                res = [r["tree"][arity] for r in ranks]
                if any(root != want["tree", arity] for _, root in res):
                    raise AssertionError(f"tree ({arity}) over {d} ranks: "
                                         f"root differs from native")
                rec["tree_ms"].setdefault(str(arity), {})[key] = max(
                    ms for ms, _ in res)
                lines.append(f"tree ({arity}, {files['tree', arity][0]}) "
                             f"{max(ms for ms, _ in res):.3f} ms, root equal "
                             f"to phase 7's native root")
            log(f"[multi] D = {d} over {backend} on "
                f"{', '.join(rec['cards'][key])} ({ranks[0]['card']}), "
                f"{time.perf_counter() - w0:.1f}s: " + "; ".join(lines))
    shared = [k for k, devs in rec["cards"].items()
              if len(set(devs)) < len(devs)]
    rec.update(correct=True, card=card_line(), device_count=cards,
               note=("CUDA-event ms, the slowest rank; worlds "
                     f"{', '.join(shared) or 'none'} share cards (gloo, CUDA "
                     "tensors staged through host memory): those prove the "
                     "program and the kernels in several processes and are "
                     "not a scaling figure"))
    log(f"[multi] launches over every rank {json.dumps(summed)}; phase 11 "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"[multi] record {json.dumps({'msm_scaling': rec})}")
    return summed, sum_rows


PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants (Linux): a process
    that a child started and left behind becomes this process's child, so
    `stop_children` finds it."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1,
                                                0, 0, 0)
    except (OSError, AttributeError):
        pass


def child_pids() -> dict:
    """{pid: command line} of this process's living children, from /proc."""
    me, out = os.getpid(), {}
    for d in os.listdir("/proc") if os.path.isdir("/proc") else ():
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
            if int(ppid) != me or state == "Z":
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                out[int(d)] = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()[:200]
        except (OSError, ValueError):
            pass
    return out


def signal_child(pid: int, sig: int) -> None:
    """Send `sig` to a child and reap it if it has ended."""
    try:
        os.kill(pid, sig)
        os.waitpid(pid, os.WNOHANG)
    except (ProcessLookupError, ChildProcessError):
        pass


def stop_children() -> None:
    """End every process this run started that is still alive: the
    multiprocessing children, the resource tracker that phase 11's queue
    started (it ignores SIGTERM and ends when its pipe closes; the
    garbage collector runs first, so that no semaphore of a dropped queue
    starts it again at exit), and any other child or adopted orphan
    (SIGTERM, then SIGKILL after 5 s). Each is reaped, and each one found
    is named on standard error."""
    import gc
    from multiprocessing import resource_tracker

    gc.collect()
    for p in multiprocessing.active_children():
        print(f"[exit] stopping process {p.pid} ({p.name})", file=sys.stderr,
              flush=True)
        p.terminate()
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None and hasattr(tracker,
                                                              "_stop"):
        print(f"[exit] stopping the resource tracker {tracker._pid}",
              file=sys.stderr, flush=True)
        tracker._stop()
    left = child_pids()
    for pid, cmd in left.items():
        print(f"[exit] stopping child {pid}: {cmd}", file=sys.stderr,
              flush=True)
        signal_child(pid, signal.SIGTERM)
    deadline = time.monotonic() + 5
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        for pid in left:
            signal_child(pid, 0)
        left = child_pids()
    for pid in left:
        signal_child(pid, signal.SIGKILL)
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


def foreign_modules() -> list[str]:
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "infimum_tpu")]


def main(argv: list[str]) -> int:
    smoke_t0 = time.perf_counter()
    if argv not in ([], ["--multi-gpu"]):
        print("usage: chip_smoke.py [--multi-gpu]", file=sys.stderr)
        return 2
    multi_only = argv == ["--multi-gpu"]
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
    from infimum_tpu_torch.groth16 import pkcache
    from infimum_tpu_torch.groth16.pkcache import default_cache_dir

    os.makedirs(default_cache_dir(), exist_ok=True)
    cache_before = set(os.listdir(default_cache_dir()))
    # setup's calls in the e2e: a miss runs it, and each of its calls
    # launches each fixed-base instance once
    setups = []
    real_setup = pkcache.setup

    def counted_setup(*a, **k):
        setups.append(1)
        return real_setup(*a, **k)

    pkcache.setup = counted_setup
    kernels.reset_counts()
    try:
        t0 = time.perf_counter()
        run = run_reference_e2e(verbose=True, device="cuda")
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        pkcache.setup = real_setup
    log(f"[e2e] {e2e_s:.1f}s timings {json.dumps(run.timings)}")
    witness_native = run.keys.process_circuit.cs._native_prog() is not None
    log(f"[e2e] verifier: native pairing ({native._LIB_PATH}); witness: "
        f"{'native hint program' if witness_native else 'python hints'}")
    log(f"[e2e] kernel launches: {launches}")
    if multi_only:
        # the phase's inputs: the e2e's key and witness, the poll's trees
        _, _, trees = poll_trees(native)
        multi_gpu_phase(run, trees, mul_rate)
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    batch_times(run.timings)
    e2e_records(run.timings)
    cache_hit(run, cache_before, launches, len(setups))

    # 4. kernel vs plain on the first process proof's inputs
    first = run.first_process
    cmp = kernel_vs_plain(run.keys.process_pk, run.keys.process_circuit.cs,
                          first["witness"], mul_rate)
    h_rows_report, pass_input = h_kernels(run, mul_rate)
    cmp.update(h_rows_report)
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
               if n == 0 and k.startswith(("msm_", "fr_"))]
    if missing:
        raise AssertionError(f"kernels never launched in the e2e: {missing}")
    if foreign_modules():
        raise AssertionError(f"JAX or infimum_tpu imported: "
                             f"{foreign_modules()[:5]}")
    log("[path] all MSM and H pipeline kernels launched in the e2e run; no "
        "JAX and no infimum_tpu module imported")

    # 7. Poseidon: the poll's trees, the benchmark's batch, every width
    launches["poseidon_perm"], tree_err, trees = poll_trees(native)
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
    fixed_rows, gen_launches = zkey_phase(run, mul_rate, pass_input)
    cmp.update(fixed_rows)
    for name, n in gen_launches.items():      # key generation's path
        launches[name] += n
    parallel_phase(run)

    # 11. the multi-GPU slice; its ranks' launches join the report's
    summed, sum_rows = multi_gpu_phase(run, trees, mul_rate)
    cmp.update(sum_rows)
    for name, n in summed.items():
        launches[name] = launches.get(name, 0) + n
    if foreign_modules():
        raise AssertionError(f"JAX or infimum_tpu imported: "
                             f"{foreign_modules()[:5]}")
    log(f"[path] no JAX and no infimum_tpu module imported; smoke "
        f"{time.perf_counter() - smoke_t0:.1f}s")

    report = []
    for name, source, replaces in KERNEL_ROWS:
        err, ms, plain_ms, bound_ms, bound_by, *library = cmp[name]
        report.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[name],
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library[0] if library else None))
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        code = main(sys.argv[1:])
    finally:
        stop_children()
    sys.exit(code)
