"""Smoke run of infimum_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
  1. probe: torch / CUDA versions, the card, compute capability 9.0;
  2. build: the CUDA kernels from infimum_tpu_torch/csrc/ (nvcc, sm_90a);
  3. e2e: the reference-dims poll, ProcessMessages(10,2,1,2) and
     TallyVotes(10,1,2): setup on the card, the poll lifecycle, all six
     batches proved through infimum_tpu_torch, each verified by the native
     pairing against the poll's own public inputs, outcome option 5;
  4. kernel vs plain: on the first process proof's inputs (the G1 `a` query
     and the G2 `b2` query) each kernel and its plain torch version give the
     same window points as affine points; both are timed;
  5. negative checks: a tampered proof and a wrong public input are
     rejected;
  6. path checks: every kernel was launched in the e2e run, and no JAX
     module was imported.
The last two lines of standard output are a JSON line with each kernel's
launches, error and times, then the card's name and power limit; the very
last line is the result: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_ROWS = (
    ("msm_accum", "infimum_tpu_torch/csrc/msm_accum.cu",
     "infimum_tpu/msm/pallas_msm.py:211"),
    ("msm_weighted", "infimum_tpu_torch/csrc/msm_weighted.cu",
     "infimum_tpu/msm/pallas_msm.py:380"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int):
    """(mean milliseconds of fn() over `reps` runs by CUDA events, the last
    run's result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def kernel_vs_plain(pk, witness):
    """Compare each kernel with its plain version on the first process
    proof's `a` (G1) and `b2` (G2) MSM inputs; returns per-kernel rows."""
    from infimum_tpu.ff.bn254 import FR_MOD
    from infimum_tpu_torch.curve.proj import G1_DEV, G2_DEV
    from infimum_tpu_torch.ff.fp import NLIMBS, ints_to_tensor
    from infimum_tpu_torch.groth16.groth16 import _query_encoding
    from infimum_tpu_torch.msm import msm as M

    w = ints_to_tensor([x % FR_MOD for x in witness], "cuda")
    rows_out = {}
    for name, points, curve in (("a", pk.a_query, G1_DEV),
                                ("b2", pk.b_g2_query, G2_DEV)):
        spec = M.SPECS[curve.name]
        rows, none_mask, lanes = _query_encoding(pk, name, points, curve,
                                                 "cuda")
        sc = torch.zeros((rows.shape[0], NLIMBS), dtype=torch.int64,
                         device="cuda")
        sc[:w.shape[0]] = torch.where(none_mask.unsqueeze(-1), 0, w)
        N = rows.shape[0]
        layout = M.lane_layout(rows, sc, lanes, spec)
        acc_ms, (edig, ept) = cuda_ms(lambda: M.accumulate(*layout, spec), 3)
        acc_plain_ms, plain_e = cuda_ms(
            lambda: M.accumulate_plain(*layout, spec), 1)
        K = spec.n_buckets + lanes + 2
        cdig, cpts = M.compact(edig, ept, K)
        pdig, ppts = M.compact(*plain_e, K)
        if not torch.equal(cdig, pdig):
            raise AssertionError(f"{name}: emitted digits differ")
        wt_ms, wk = cuda_ms(lambda: M.weighted_sum(cdig, cpts, spec), 3)
        wt_plain_ms, wp = cuda_ms(
            lambda: M.weighted_sum_plain(pdig, ppts, spec), 1)
        got = M.decode_windows(M.words_to_limbs(wk).cpu(), curve.name)
        want = M.decode_windows(M.words_to_limbs(wp).cpu(), curve.name)
        err = max(_affine_err(g, p) for g, p in zip(got, want))
        log(f"[kernel_vs_plain] {name} ({curve.name}, {N} rows, {lanes} "
            f"lanes): accum {acc_ms:.3f} ms vs plain {acc_plain_ms:.3f} ms;"
            f" weighted {wt_ms:.3f} ms vs plain {wt_plain_ms:.3f} ms; "
            f"window points equal: {got == want}")
        if got != want:
            raise AssertionError(f"{name}: kernel and plain windows differ")
        rows_out[f"msm_accum_{curve.name}"] = (err, acc_ms, acc_plain_ms)
        rows_out[f"msm_weighted_{curve.name}"] = (err, wt_ms, wt_plain_ms)
    return rows_out


def _affine_err(p, q) -> int:
    """Largest absolute coordinate difference of two affine points."""
    if p is None or q is None:
        return 0 if p is q else 1 << 256

    def flat(pt):
        return [c for v in pt for c in (v if isinstance(v, tuple) else (v,))]
    return max(abs(a - b) for a, b in zip(flat(p), flat(q)))


def main() -> int:
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
    log(f"[probe] nvidia-smi: {card_line()}")
    if cap != (9, 0):
        raise SystemExit(f"need compute capability 9.0, got {cap}")

    # 2. build
    from infimum_tpu_torch import kernels

    kernels.library()
    log(f"[build] {kernels.BUILD_INFO['seconds']:.1f}s -> "
        f"{kernels.BUILD_INFO['path']}")
    log(kernels.BUILD_INFO["log"].strip())

    # 3. e2e at reference dims
    from infimum_tpu import native
    from infimum_tpu_torch.client.e2e import run_reference_e2e

    if not native.available():
        raise SystemExit("native library did not load: verification would "
                         "not be the native pairing")
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

    # 4. kernel vs plain on the first process proof's inputs
    first = run.first_process
    cmp = kernel_vs_plain(run.keys.process_pk, first["witness"])

    # 5. negative checks
    from infimum_tpu.curve.bn254_host import G1_GEN, g1_add
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the e2e: {missing}")
    jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if jax_mods:
        raise AssertionError(f"JAX was imported: {jax_mods[:5]}")
    log("[path] all kernels launched in the e2e run; no JAX imported")

    report = []
    for base, source, replaces in KERNEL_ROWS:
        for curve in ("g1", "g2"):
            name = f"{base}_{curve}"
            err, ms, plain_ms = cmp[name]
            report.append(dict(name=name, route="cuda", source=source,
                               replaces=replaces, launches=launches[name],
                               max_abs_err=err, ms=ms, plain_ms=plain_ms))
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
