"""Variants of the cross-rank sum's source (`csrc/point_sum.cu`) and of the
pointwise launch's (`csrc/fr_ntt.cu`) against this tree's, in turns on one
card.

    python3 infimum_tpu_torch/bench/sum_pointwise_variants.py
        [KIND:LABEL=SOURCE ...] [--patch KIND:NAME ... | --patch all]
        [--rounds N] [--only KIND]

KIND is `sum` or `pointwise`. Variants of each kind: this tree's source;
each SOURCE given (a whole `point_sum.cu` or `fr_ntt.cu` with this tree's
C interface, e.g. `git show <commit>:infimum_tpu_torch/csrc/point_sum.cu`
written under the gitignored `.chip_scratch/`); each patch of `PATCHES`
named with `--patch` (`all`: every one), a text substitution of this
tree's source. Each is built by nvcc into a library of its own (all at
once, includes resolved in `csrc/`), and its kernel's registers, stack
and spills are printed.

Cases, inputs from a seed:
- sum: D = 2, 4 and 8 projective points a window (D random multiples of
  the generator for each of G1's 20 and G2's 26 windows, Z = 1), the
  shapes of smoke phase 11's `sum_kernels`; before the timing every
  variant's output at D = 2..16 and 64 must equal this tree's and
  `point_sum_plain`'s.
- pointwise: the key load's x R^3 over 2^18 standard-form values, the
  zkey's a.b - c (x 1) over 2^18, and the sharded NTT's twiddle product
  over rank 0's slab of 2^18 at D = 1, 2 and 4 (2^18, 2^17, 2^16 values
  times a table); every variant's output equal to this tree's and to
  `pointwise_plain`'s, and at n = 1, 3, 255, 2^16 - 1 and 2^16 + 1 too.

Times are the card's ms a call of REPS calls queued behind a spin kernel
(`chip_smoke.alone_ms`), the median of `--rounds` rounds, each round
running the variants forwards and then backwards."""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from infimum_tpu_torch import kernels  # noqa: E402
from infimum_tpu_torch.curve.bn254_host import fixed_base_mul_host  # noqa: E402
from infimum_tpu_torch.ff.bn254 import FR_MOD  # noqa: E402
from infimum_tpu_torch.ff.fp import FR_CTX, limbs_to_words  # noqa: E402
from infimum_tpu_torch.msm.msm import SPECS  # noqa: E402
from infimum_tpu_torch.ntt import ntt as N  # noqa: E402
from infimum_tpu_torch.parallel import msm as PM  # noqa: E402

SEED = 20261018
REPS = 20
SOURCES = {"sum": "point_sum.cu", "pointwise": "fr_ntt.cu"}
SUM_DS = (2, 4, 8)
CHECK_DS = tuple(range(2, 17)) + (64,)
# (label, values, b, c, k): the pointwise launch's shapes on the main path
POINTWISE_CASES = (("key load x R^3", 1 << 18, False, False, "R3"),
                   ("zkey a.b - c x 1", 1 << 18, True, True, "1"),
                   ("twiddle D = 1", 1 << 18, True, False, None),
                   ("twiddle D = 2", 1 << 17, True, False, None),
                   ("twiddle D = 4", 1 << 16, True, False, None))
CHECK_NS = (1, 3, 255, (1 << 16) - 1, (1 << 16) + 1)
# variant (a) of the sum: the levels in parallel, a whole complete add a
# thread (rcb_add over the two-chain fields, out of line)
WHOLE_ADD = """template <int K> struct WholeField { using F = FqTwoChains; };
template <> struct WholeField<2> { using F = Fq2TwoChains; };

template <int K>
__device__ __noinline__ void whole_add(const uint32_t* p, const uint32_t* q,
                                       uint32_t* dst) {
  using F = typename WholeField<K>::F;
  store_proj<F>(dst, 1, rcb_add<F>(load_proj<F>(p, 1), load_proj<F>(q, 1)));
}

// entry i of a (rows, nwin, PW) words array, for window w
"""
# the pointwise kernel's body and launch in this tree: a thread a value,
# blocks of kThreads
ONE_VALUE = """  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fr::E x = load_value(a + 8 * i);
  if (b) x = two_chains::mul<FrParams>(x, load_value(b + 8 * i));
  if (c) x = Fr::sub(x, load_value(c + 8 * i));
  if (k) x = two_chains::mul<FrParams>(x, load_value(k));
  store_value(out + 8 * i, x);
"""
GRID = """  const unsigned blocks = (unsigned)((n + inf::kThreads - 1) / inf::kThreads);
  inf::fr_pointwise_kernel<<<blocks, inf::kThreads, 0,"""
# V values a thread, blockDim.x apart, all loaded before the first product
V_VALUES = """  constexpr int V = {v};
  const size_t i0 = size_t(blockIdx.x) * blockDim.x * V + threadIdx.x;
  Fr::E x[V], y[V], z[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {{
    const size_t i = i0 + size_t(v) * blockDim.x;
    if (i >= n) continue;
    x[v] = load_value(a + 8 * i);
    if (b) y[v] = load_value(b + 8 * i);
    if (c) z[v] = load_value(c + 8 * i);
  }}
  const Fr::E kk = k ? load_value(k) : Fr::E{{}};
#pragma unroll
  for (int v = 0; v < V; ++v) {{
    const size_t i = i0 + size_t(v) * blockDim.x;
    if (i >= n) continue;
    if (b) x[v] = two_chains::mul<FrParams>(x[v], y[v]);
    if (c) x[v] = Fr::sub(x[v], z[v]);
    if (k) x[v] = two_chains::mul<FrParams>(x[v], kk);
    store_value(out + 8 * i, x[v]);
  }}
"""
V_GRID = """  const size_t per = size_t(inf::kThreads) * {v};
  inf::fr_pointwise_kernel<<<(unsigned)((n + per - 1) / per), inf::kThreads, 0,"""
# blocks of kThreads halved (down to one warp) while the grid would give an
# SM fewer than m of them
BY_N_GRID = """  const int sms = inf::sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  int threads = inf::kThreads;
  while (threads > 32 && (n + threads - 1) / threads < {m} * sms) threads /= 2;
  inf::fr_pointwise_kernel<<<(n + threads - 1) / threads, threads, 0,"""


def values(v: int) -> list[tuple[str, str]]:
    return [(ONE_VALUE, V_VALUES.format(v=v)), (GRID, V_GRID.format(v=v))]


# the sum's additions and subtractions as field.cuh's 64-bit word loops,
# in place of this tree's carry chains (the same reduced values)
WORD_ADDS = """// a + b, a - b and 9x as field.cuh's Fq computes them
__device__ __forceinline__ Fq::E fq_add(const Fq::E& a, const Fq::E& b) {
  return Fq::add(a, b);
}

__device__ __forceinline__ Fq::E fq_sub(const Fq::E& a, const Fq::E& b) {
  return Fq::sub(a, b);
}

__device__ __forceinline__ Fq::E fq_b3(const Fq::E& x) { return Fq::b3(x); }

"""
# the warp's slots read and written as 16-byte vectors
SLOT_ACCESS = """  __device__ __forceinline__ Fq::E get(int i) const {
    return Fq::load(s[i], 1);
  }
  __device__ __forceinline__ void put(int i, const Fq::E& a) const {
    Fq::store(s[i], 1, a);
  }"""
VECTOR_SLOT_ACCESS = """  __device__ __forceinline__ Fq::E get(int i) const {
    const uint4 lo = reinterpret_cast<const uint4*>(s[i])[0];
    const uint4 hi = reinterpret_cast<const uint4*>(s[i])[1];
    return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  }
  __device__ __forceinline__ void put(int i, const Fq::E& a) const {
    uint4* v = reinterpret_cast<uint4*>(s[i]);
    v[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
    v[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
  }"""


def _source_span(start: str, end: str) -> str:
    """The text of this tree's point_sum.cu from `start` up to `end`."""
    text = (kernels.CSRC / SOURCES["sum"]).read_text()
    return text[text.index(start):text.index(end)]
# text substitutions of this tree's sources: {kind: {name: [(old, new)]}}
PATCHES: dict[str, dict[str, list[tuple[str, str]]]] = {
    "sum": {
        "(a) whole adds a thread": [
            ("// entry i of a (rows, nwin, PW) words array, for window w\n",
             WHOLE_ADD),
            ("for (int i = warp; i < half; i += warps)\n    warp_add<K>(",
             "for (int i = threadIdx.x; i < half; i += blockDim.x)\n"
             "    whole_add<K>("),
            ("for (int i = warp; i < h; i += warps)  // entry i read, then "
             "written\n      warp_add<K>(",
             "for (int i = threadIdx.x; i < h; i += blockDim.x)\n"
             "      whole_add<K>("),
            ("win, nwin),\n                lane, w);",
             "win, nwin));"),
            ("win, nwin),\n                  lane, w);",
             "win, nwin));")],
        "64-bit word adds": [(_source_span(
            "// a + b and a - b mod q over the carry flag",
            "// component c of the Karatsuba product"), WORD_ADDS)],
        "vector slots": [(SLOT_ACCESS, VECTOR_SLOT_ACCESS),
                         ("__shared__ uint32_t slots[",
                          "__shared__ __align__(16) uint32_t slots[")],
        "one carry chain": [("FqTwoChains::mul(", "FqOutOfLine::mul(")],
        "product inlined": [("FqTwoChains::mul(",
                             "two_chains::mul<FqParams>(")],
    },
    "pointwise": {
        "one carry chain": [("two_chains::mul<FrParams>(", "Fr::mul(")],
        "2 values a thread": values(2),
        "4 values a thread": values(4),
        "grid by n, 4 blocks an SM": [(GRID, BY_N_GRID.format(m=4))],
        "grid by n, 8 blocks an SM": [(GRID, BY_N_GRID.format(m=8))],
    },
}


def patched(kind: str, name: str) -> str:
    """This tree's source of `kind` with the patch `name` applied ("A+B":
    A, then B)."""
    text = (kernels.CSRC / SOURCES[kind]).read_text()
    for part in name.split("+"):
        for old, new in PATCHES[kind][part]:
            if old not in text:
                raise ValueError(f"patch {kind}:{part}: {old[:60]!r} is not "
                                 f"in {SOURCES[kind]}")
            text = text.replace(old, new)
    return text


class Variant:
    """A library built from one source: its kernel's resources and its C
    entry points (this tree's signatures)."""

    def __init__(self, kind: str, label: str, lib, log: str):
        self.kind, self.label, self.lib = kind, label, lib
        want = "point_sum" if kind == "sum" else "fr_pointwise"
        self.usage = [m for m in chip_smoke.RESOURCES.finditer(log)
                      if want in m.group(1)]
        names = (("point_sum_g1", "point_sum_g2") if kind == "sum"
                 else ("fr_pointwise",))
        for name in names:
            fn = getattr(lib, kernels.KERNELS[name].symbol)
            fn.argtypes = kernels.KERNELS[name].argtypes
            fn.restype = ctypes.c_int

    def resources(self) -> str:
        return "; ".join(
            f"{m.group(1)}: {m.group(5)} registers, {m.group(2)} B stack, "
            f"{m.group(3)}/{m.group(4)} B spill stores/loads" for m in
            self.usage) or "no resource report"

    def call(self, symbol: str, *args) -> None:
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        rc = getattr(self.lib, symbol)(
            *ptrs, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.label}: {symbol}: cudaError {rc}")


def build(kind: str, label: str, text: str, out: pathlib.Path) -> Variant:
    d = out / f"{kind}_{re.sub(r'[^A-Za-z0-9]+', '_', label)}"
    d.mkdir(parents=True, exist_ok=True)
    src = d / SOURCES[kind]
    src.write_text(text)
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-shared",
         "-o", str(d / "lib.so"), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{kind}:{label}: nvcc failed\n{proc.stdout}"
                           f"{proc.stderr}")
    return Variant(kind, label, ctypes.CDLL(str(d / "lib.so")),
                   proc.stdout + proc.stderr)


def sum_points(curve: str, d: int, rng) -> torch.Tensor:
    """(d, nwin, PW) projective words on the card: random multiples of
    the generator, Z = 1."""
    spec = SPECS[curve]
    cdev, nwin = spec.curve, spec.n_windows
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(d * nwin)]
    aff = cdev.encode_affine(fixed_base_mul_host(ks, curve), "cpu")
    x, y = aff[:, 0], aff[:, 1]
    z = cdev.one((d * nwin,), "cpu")
    words = limbs_to_words(torch.cat([c.flatten(1) for c in (x, y, z)], 1))
    return words.reshape(d, nwin, spec.PW).contiguous().cuda()


def sum_call(v: Variant, curve: str, every: torch.Tensor, scratch, out):
    d, nwin = every.shape[:2]
    v.call(kernels.KERNELS[f"point_sum_{curve}"].symbol, every, scratch, out,
           d, nwin)
    return out


def sum_scratch(every: torch.Tensor) -> torch.Tensor:
    d, nwin, pw = every.shape
    return every.new_empty((1 << (d - 1).bit_length() - 1, nwin, pw))


def fr_values(n: int, rng) -> torch.Tensor:
    """(n, 8) int32 words of values below r (the top word below r's)."""
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    w[:, 7] %= FR_MOD >> 224
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).cuda()


def pointwise_inputs(n: int, b: bool, c: bool, k, rng):
    a = fr_values(n, rng)
    kw = None if k is None else N.fr_const(
        FR_CTX.R2 * FR_CTX.R if k == "R3" else 1, "cuda", mont=False)
    return (a, fr_values(n, rng) if b else None,
            fr_values(n, rng) if c else None, kw)


def pointwise_call(v: Variant, ins, out):
    v.call("inf_fr_pointwise", *ins, out, out.shape[0])
    return out


def check_sum(built: list[Variant], rng) -> None:
    for curve in ("g1", "g2"):
        for d in CHECK_DS:
            every = sum_points(curve, d, rng)
            want = PM.point_sum_plain(every, curve)
            for v in built:
                out = torch.empty_like(want)
                got = sum_call(v, curve, every, sum_scratch(every), out)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"sum:{v.label}: {curve} at D = {d}"
                                         f" differs from plain")
    print(f"[variants] sum: every variant equal to plain at D = "
          f"{', '.join(map(str, CHECK_DS))}, G1 and G2", flush=True)


def check_pointwise(built: list[Variant], rng) -> None:
    cases = [(n, *rest) for _, n, *rest in POINTWISE_CASES] + [
        (n, True, True, "R3") for n in CHECK_NS] + [
        (n, True, False, None) for n in CHECK_NS]
    for n, b, c, k in cases:
        ins = pointwise_inputs(n, b, c, k, rng)
        want = N.pointwise_plain(*ins)
        for v in built:
            got = pointwise_call(v, ins, torch.empty_like(ins[0]))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pointwise:{v.label}: n = {n} differs "
                                     f"from plain")
    print(f"[variants] pointwise: every variant equal to plain at the five "
          f"shapes and n = {', '.join(map(str, CHECK_NS))}", flush=True)


def in_turns(built: list[Variant], cases: dict, rounds: int) -> None:
    """cases: {label: fn(variant)}; prints each variant's median ms."""
    for label, fn in cases.items():
        times = {v.label: [] for v in built}
        for _ in range(rounds):
            for v in built + built[::-1]:
                ms, _, _ = chip_smoke.alone_ms(lambda: fn(v), REPS)
                times[v.label].append(ms)
        print(f"[variants] {label}: " + "; ".join(
            f"{name} {sorted(t)[len(t) // 2]:.4f} ms (of "
            f"{', '.join(f'{x:.4f}' for x in t)})"
            for name, t in times.items()), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", metavar="KIND:LABEL=SOURCE")
    ap.add_argument("--patch", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", choices=tuple(SOURCES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sum_pointwise_variants: no CUDA device", file=sys.stderr)
        return 1
    kinds = (args.only,) if args.only else tuple(SOURCES)
    texts = {(kind, "this tree"): (kernels.CSRC / SOURCES[kind]).read_text()
             for kind in kinds}
    names = ([f"{k}:{n}" for k in kinds for n in PATCHES[k]]
             if args.patch == ["all"] else args.patch)
    for spec in names:
        kind, name = spec.split(":", 1)
        if kind in kinds:
            texts[kind, name] = patched(kind, name)
    for spec in args.sources:
        kind, rest = spec.split(":", 1)
        label, path = rest.split("=", 1)
        if kind in kinds:
            texts[kind, label] = pathlib.Path(path).read_text()
    print(f"[variants] card {chip_smoke.card_line()}", flush=True)
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
            built = list(pool.map(
                lambda kv: build(*kv[0], kv[1], pathlib.Path(tmp)),
                texts.items()))
        for v in built:
            print(f"[variants] {v.kind}:{v.label}: {v.resources()}",
                  flush=True)
        by_kind = {k: [v for v in built if v.kind == k] for k in kinds}
        if "sum" in kinds:
            check_sum(by_kind["sum"], rng)
            cases = {}
            for curve in ("g1", "g2"):
                for d in SUM_DS:
                    every = sum_points(curve, d, rng)
                    scratch = sum_scratch(every)
                    out = every.new_empty(every.shape[1:])
                    cases[f"sum {curve.upper()} D = {d}"] = (
                        lambda v, c=curve, e=every, s=scratch, o=out:
                        sum_call(v, c, e, s, o))
            in_turns(by_kind["sum"], cases, args.rounds)
        if "pointwise" in kinds:
            check_pointwise(by_kind["pointwise"], rng)
            cases = {}
            for label, n, b, c, k in POINTWISE_CASES:
                ins = pointwise_inputs(n, b, c, k, rng)
                out = torch.empty_like(ins[0])
                cases[f"pointwise {label} ({n} values)"] = (
                    lambda v, i=ins, o=out: pointwise_call(v, i, o))
            in_turns(by_kind["pointwise"], cases, args.rounds)
    print(f"[variants] card {chip_smoke.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
