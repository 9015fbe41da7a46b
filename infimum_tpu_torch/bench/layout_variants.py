"""Variants of the MSM glue's kernel source (`csrc/msm_layout.cu`) against
this tree's, in turns on one card.

    python3 infimum_tpu_torch/bench/layout_variants.py [LABEL=DIR ...]
        [--derive LABEL=SOURCE] [--unchecked LABEL] [--rounds N]

Each DIR holds its own `msm_layout.cu` with this tree's C interface (the
`inf_msm_{recode,scan,scatter,compact}_*` entry points of
`kernels.KERNELS`); its includes resolve in DIR first, then in `csrc/`.
`--derive LABEL=SOURCE` adds three variants made from one source of the
scatter written with `__match_any_sync` (the kernel of commit 3bc5e0d):
the source as it is, the source with the scatter's two slot stores of
`order` and `ssgn` removed (named "... without slot stores", only timed),
and the source with each `__match_any_sync` replaced by a rank from one
`__ballot_sync` a bit of |digit| ("... ballot rank"). Each variant is
built with nvcc into a library of its own (all at once), and its
kernels' registers and spills are printed.

Cases, at the five MSM shapes of a process proof (`a`, `b1`, `l` over
143,360 G1 rows, `h` over 262,144, `b2` over 141,312 G2 rows; the lanes
`prove()` takes), scalars from a seed with about the share of zero
digits of the reference-dims poll's first process proof at each shape
(mixed adds and live emissions against entries): the scatter (`layout_scatter` on the recode and scan of the
variant's own source, whose `kChunkG1` / `kChunkG2` set the specs'
`layout_chunk` in its turn) and the compaction (`compact`, on the
emissions of this tree's layout and accumulation over random table
words). Each case runs on every library in turn, this tree's first,
through the port's own wrappers; every output must equal this tree's
unless the variant is named with `--unchecked`. Times are the card's ms
a call of 10 calls queued behind a spin kernel (so the host's Python
between launches is not timed), the median of `--rounds` rounds, each
round running the variants forwards and then backwards; then one
profiled round a variant splits a call's device time by kernel (each
grid of the compaction alone)."""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from infimum_tpu_torch import kernels  # noqa: E402
from infimum_tpu_torch.msm import msm as M  # noqa: E402

SOURCE = "msm_layout.cu"
SEED = 20261018
# (curve, rows, lanes, share of zero scalars) of each MSM of a process
# proof: the share is 1 - (mixed adds + live emissions) / entries of the
# reference-dims poll's first process proof at that shape
SHAPES = {"a": ("g1", 143360, 4096, 0.34), "b1": ("g1", 143360, 4096, 0.46),
          "l": ("g1", 143360, 4096, 0.18), "h": ("g1", 262144, 4096, 0.0),
          "b2": ("g2", 141312, 2048, 0.45)}
REPS = 10
SPIN_CYCLES = 20_000_000           # torch.cuda._sleep: about 10 ms
RESOURCES = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
    r"spill stores, (\d+) bytes spill loads\nptxas info\s*: Used (\d+) "
    r"registers")
SLOT_STORES = ("      order[row + dest] = lo + 32 * j + lane;\n"
               "      ssgn[row + dest] = p >> 15;\n")
BALLOT_RANK = '''
// the lanes of the warp whose d equals this lane's, from one ballot a bit
// (d < 2^Bits)
template <int Bits>
__device__ __forceinline__ unsigned ballot_peers(int d) {
  unsigned m = ~0u;
#pragma unroll
  for (int b = 0; b < Bits; ++b) {
    const unsigned v = __ballot_sync(~0u, (d >> b) & 1);
    m &= (d >> b) & 1 ? v : ~v;
  }
  return m;
}
'''


def derive(label: str, source: pathlib.Path, out: pathlib.Path) -> dict:
    """{label: dir} of the three variants `--derive` makes from `source`."""
    text = source.read_text()
    if (text.count(SLOT_STORES) != 1
            or text.count("__match_any_sync(~0u, d)") != 2):
        raise ValueError(f"{source}: not a scatter with two __match_any_sync "
                         f"and one pair of slot stores")
    anchor = "// -- 1. recode"
    made = {label: text,
            f"{label} without slot stores": text.replace(SLOT_STORES, ""),
            f"{label} ballot rank": text.replace(
                "__match_any_sync(~0u, d)",
                "ballot_peers<P::kBits>(d)").replace(
                anchor, BALLOT_RANK.lstrip() + "\n" + anchor, 1)}
    dirs = {}
    for name, body in made.items():
        d = out / re.sub(r"[^A-Za-z0-9]+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(body)
        dirs[name] = d
    return dirs


def chunks(source: pathlib.Path) -> tuple[int, int]:
    """(kChunkG1, kChunkG2) of an `msm_layout.cu`."""
    text = source.read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
                 for name in ("kChunkG1", "kChunkG2"))


def usage(log: str) -> str:
    """The layout kernels' registers and spills in an nvcc report."""
    return "; ".join(
        f"{m.group(1)}: {m.group(5)} registers, {m.group(3)}/{m.group(4)} B "
        f"spill stores/loads" for m in RESOURCES.finditer(log)
        if re.search(r"msm_(recode|count|scan|scatter|compact)", m.group(1)))


def build(label: str, d: pathlib.Path, out: pathlib.Path):
    """(library, chunks) of a variant directory."""
    src = d / SOURCE
    lib = out / f"{re.sub(r'[^A-Za-z0-9]+', '_', label)}.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{d}", f"-I{kernels.CSRC}",
         "-shared", "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    print(f"[variants] {label}: {usage(proc.stdout + proc.stderr)}",
          flush=True)
    so = ctypes.CDLL(str(lib))
    for k in layout_kernels():
        fn = getattr(so, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    return so, chunks(src)


def layout_kernels():
    return [k for name, k in kernels.KERNELS.items()
            if name.startswith(("msm_recode", "msm_scan", "msm_scatter",
                                "msm_compact"))]


@contextlib.contextmanager
def swapped(lib, chunk: tuple[int, int]):
    """This variant's library and layout chunks in the port's wrappers."""
    saved = kernels._lib, M.G1_SPEC.layout_chunk, M.G2_SPEC.layout_chunk
    kernels._lib = lib
    M.G1_SPEC.layout_chunk, M.G2_SPEC.layout_chunk = chunk
    try:
        yield
    finally:
        kernels._lib, M.G1_SPEC.layout_chunk, M.G2_SPEC.layout_chunk = saved


def alone_ms(fn) -> float:
    """The card's ms a call of REPS calls of fn() queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_ms(fn) -> dict:
    """{device kernel: ms a call} of REPS calls of fn() under
    torch.profiler, from its Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = re.sub(r"<.*", "", e["name"].split("(")[0])
            out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / REPS
    return out


def scalars(rng, n: int, zeros: float) -> torch.Tensor:
    """(n, 16) standard-form limbs of scalars below r on the card, about
    `zeros` of them zero."""
    w = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    w[:, 15] &= 0x1FFF                                 # below 2^253 < r
    w[rng.random(n) < zeros] = 0
    return torch.from_numpy(w).cuda()


def compaction_inputs(rng, sc, lanes: int, spec):
    """(edig, ept, K): this tree's layout and accumulation of `sc` over a
    table of random words below 2^252."""
    n = sc.shape[0]
    words = rng.integers(0, 1 << 32, size=(n, spec.AW), dtype=np.int64)
    words[:, 7::8] &= 0x0FFFFFFF
    table = torch.from_numpy(words.astype(np.int32)).cuda()
    edig, ept = M.accumulate(*M.lane_layout(table, sc, lanes, spec), spec)
    return edig, ept, spec.n_buckets + lanes + 2


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", metavar="LABEL=DIR")
    ap.add_argument("--derive", action="append", default=[],
                    metavar="LABEL=SOURCE")
    ap.add_argument("--unchecked", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("layout_variants: no CUDA device", file=sys.stderr)
        return 1
    kernels.library()
    print(f"[variants] this tree: {usage(kernels.BUILD_INFO['log'])}; "
          f"scatter blocks an SM "
          f"{kernels.scatter_blocks_per_sm('g1')} (G1), "
          f"{kernels.scatter_blocks_per_sm('g2')} (G2)", flush=True)
    libs = {"this tree": (kernels._lib, (M.G1_SPEC.layout_chunk,
                                         M.G2_SPEC.layout_chunk))}
    unchecked = set(args.unchecked)
    with tempfile.TemporaryDirectory() as tmp:
        pairs = [v.split("=", 1) for v in args.variants]
        for spec in args.derive:
            label, src = spec.split("=", 1)
            made = derive(label, pathlib.Path(src), pathlib.Path(tmp))
            unchecked.add(f"{label} without slot stores")
            pairs += [(k, str(v)) for k, v in made.items()]
        with concurrent.futures.ThreadPoolExecutor(max(1, len(pairs))) as pool:
            built = pool.map(lambda p: build(p[0], pathlib.Path(p[1]),
                                             pathlib.Path(tmp)), pairs)
            libs.update(zip((p[0] for p in pairs), built))
        rng = np.random.default_rng(SEED)
        for shape, (curve, n, lanes, zeros) in SHAPES.items():
            spec = M.SPECS[curve]
            sc = scalars(rng, n, zeros)
            edig, ept, K = compaction_inputs(rng, sc, lanes, spec)
            live = int((edig > 0).sum())
            scatter_in = {}
            for label, (lib, chunk) in libs.items():
                with swapped(lib, chunk):
                    packed, counts = M.layout_recode(sc, spec)
                    scatter_in[label] = (packed, counts,
                                         M.layout_scan(counts))
            cases = {
                "scatter": lambda label: M.layout_scatter(
                    *scatter_in[label], spec),
                f"compaction ({live} live of {edig.numel()} emissions)":
                    lambda label: M.compact(edig, ept, K)}
            for case, fn in cases.items():
                want = fn("this tree")
                times = {label: [] for label in libs}
                grids = {}
                for label, (lib, chunk) in libs.items():
                    with swapped(lib, chunk):
                        got = fn(label)
                        if label not in unchecked and not all(
                                torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(f"{label}: {shape} {case} "
                                                 f"differs from this tree's")
                        grids[label] = kernel_ms(lambda: fn(label))
                order = list(libs.items())
                for _ in range(args.rounds):
                    for label, (lib, chunk) in order + order[::-1]:
                        with swapped(lib, chunk):
                            times[label].append(alone_ms(lambda: fn(label)))
                print(f"[variants] {shape} ({curve}, {n} rows, {lanes} "
                      f"lanes) {case} ms: " + "; ".join(
                          f"{label} {sorted(t)[len(t) // 2]:.4f} (grids "
                          + ", ".join(f"{k} {v:.4f}"
                                      for k, v in grids[label].items()) + ")"
                          for label, t in times.items()), flush=True)
            del edig, ept, scatter_in
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[variants] card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
