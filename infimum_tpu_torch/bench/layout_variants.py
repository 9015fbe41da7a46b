"""Variants of the MSM glue's kernel source (`csrc/msm_layout.cu`) against
this tree's, in turns on one card.

    python3 infimum_tpu_torch/bench/layout_variants.py [LABEL=DIR ...]
        [--baseline LABEL=SOURCE] [--unchecked LABEL] [--rounds N]
        [--no-scatter]

Each DIR holds its own `msm_layout.cu`; its includes resolve in DIR first,
then in `csrc/`. A source has one of two C interfaces for the recode,
told apart by its symbols:
  - "words" (this tree's): `inf_msm_recode_{g1,g2}` takes the scalars'
    standard-form words (n, 8) int32, the rows N >= n of the query and its
    infinity mask, and writes packed, the scanned offsets and the totals;
  - "limbs" (commit c6f14c6 and before): `inf_msm_recode_{g1,g2}` takes
    (N, 16) int64 limbs, padded and masked by torch, and writes packed and
    the block counts, which `inf_msm_scan` scans in place.
The scatter and compaction entries are the same in both.
`--baseline LABEL=SOURCE` adds three variants made from a source with the
limbs interface (`git show c6f14c6:infimum_tpu_torch/csrc/msm_layout.cu`):
the source as it is, the source reading (N, 8) int32 words in place of
the limbs ("LABEL words", fed the padded, masked words), and the source
with its count grid's stores of the counts removed ("LABEL without count
stores", only timed). Each variant is built with nvcc into a library of
its own (all at once), and its kernels' registers and spills are printed.

Cases, at the five MSM shapes of a process proof (`a`, `b1`, `l` over
143,360 G1 rows, `h` over 262,144, `b2` over 141,312 G2 rows; the
witness's 139,647 values, `l` without the 10 public ones, `h`'s 262,143;
the lanes `prove()` takes), scalars from a seed, about the share of zero
digits of the reference-dims poll's first process proof at each shape
zero, half of those as zero scalars and half as rows the query's
infinity mask drops:
  - the scalars' path, from the words and the mask to (packed, offsets,
    totals): a words library's one call; a limbs library's
    `words_to_limbs`, the padded, masked int64 copy `_msm_inputs` made,
    the recode, the count grid and the scan, as a steady prove issued
    them; the words variant's padded, masked words, recode and scan;
  - a limbs library's recode (both grids) alone on its padded input, and
    its scan alone (on copies of the counts);
  - `torch.cumsum(counts, 1)` (the scan's library yardstick, timed once a
    shape; the port never calls it);
  - unless `--no-scatter`, for each variant not named `--unchecked`,
    the scatter (`layout_scatter` on the variant's own path outputs, its
    `kChunkG1` / `kChunkG2` setting the specs' `layout_chunk` in its
    turn) and the compaction (`compact`, on the emissions of this tree's
    layout and accumulation over random table words).
Then the five paths together as one steady process prove issues them
(the witness's words converted once for `a`, `b1`, `b2` and `l` on a
limbs library). Every output must equal this tree's unless the variant
is named with `--unchecked`. Times are the card's ms a call of 10 calls
queued behind a spin kernel (so the host's Python between launches is
not timed), the median of `--rounds` rounds, each round running the
variants forwards and then backwards; then one profiled round a variant
splits a call's device time by kernel (each grid alone). The host's
enqueue ms of the path is printed beside it."""

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
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from infimum_tpu_torch import kernels  # noqa: E402
from infimum_tpu_torch.ff.fp import NLIMBS, words_to_limbs  # noqa: E402
from infimum_tpu_torch.msm import msm as M  # noqa: E402

SOURCE = "msm_layout.cu"
SEED = 20261018
NV, NPUB = 139647, 10    # the process circuit's witness and public values
# (curve, rows, scalars, lanes, share of zero digits) of each MSM of a
# process proof: the share is 1 - (mixed adds + live emissions) / entries
# of the reference-dims poll's first process proof at that shape
SHAPES = {"a": ("g1", 143360, NV, 4096, 0.34),
          "b1": ("g1", 143360, NV, 4096, 0.46),
          "l": ("g1", 143360, NV - NPUB, 4096, 0.18),
          "h": ("g1", 262144, 262143, 4096, 0.0),
          "b2": ("g2", 141312, NV, 2048, 0.45)}
REPS = 10
SPIN_CYCLES = 20_000_000           # torch.cuda._sleep: about 10 ms
RESOURCES = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
    r"spill stores, (\d+) bytes spill loads\nptxas info\s*: Used (\d+) "
    r"registers")
# the limbs interface's recode and scan: (pointers, ints) before the stream
LIMBS_RECODE, LIMBS_SCAN = (3, 2), (2, 3)
LIMB_LOAD = """  const longlong2* row = reinterpret_cast<const longlong2*>(sc) + (size_t)i * 8;
  uint32_t w[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const longlong2 v = __ldg(row + k);
    w[k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
  }
"""
WORD_LOAD = """  const uint4* row = reinterpret_cast<const uint4*>(sc) + (size_t)i * 2;
  const uint4 lo = __ldg(row), hi = __ldg(row + 1);
  uint32_t w[9] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, 0};
"""
COUNT_STORE = ("  for (int b = threadIdx.x; b < P::kBins; b += kCountThreads) "
               "out[b] = hist[b];\n")
# never true: the histogram is still counted and read, nothing is stored
NO_COUNT_STORE = ("  for (int b = threadIdx.x; b < P::kBins; b += kCountThreads)"
                  "\n    if (hist[b] < 0) out[b] = hist[b];\n")


def baseline(label: str, source: pathlib.Path, out: pathlib.Path) -> dict:
    """{label: dir} of the three variants `--baseline` makes from `source`
    (the limbs interface)."""
    text = source.read_text()
    if text.count(LIMB_LOAD) != 1 or text.count(COUNT_STORE) != 1:
        raise ValueError(f"{source}: not a recode reading limbs with one "
                         f"count grid")
    made = {label: text,
            f"{label} words": text.replace(LIMB_LOAD, WORD_LOAD),
            f"{label} without count stores": text.replace(COUNT_STORE,
                                                          NO_COUNT_STORE)}
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
        if re.search(r"msm_(recode|count|scan|layout|scatter|compact)",
                     m.group(1)))


class Variant:
    """A built library, its interface ("words" or "limbs"), its chunks,
    and whether it reads words in place of limbs (a limbs-interface
    source made by `baseline`)."""

    def __init__(self, lib, chunk, reads_words=False):
        self.lib, self.chunk = lib, chunk
        self.iface = "limbs" if hasattr(lib, "inf_msm_scan") else "words"
        self.reads_words = reads_words
        for k in kernels.KERNELS.values():
            if k.symbol.startswith(("inf_msm_scatter", "inf_msm_compact")) \
                    or self.iface == "words" and k.symbol.startswith(
                        "inf_msm_recode"):
                fn = getattr(lib, k.symbol)
                fn.argtypes, fn.restype = k.argtypes, ctypes.c_int

    def call(self, symbol: str, sig, *args):
        """A limbs-interface entry: `sig` (pointers, ints)."""
        fn = getattr(self.lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * sig[0] + [ctypes.c_int] * sig[1]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{symbol}: cudaError {rc}")

    def recode(self, sc, spec):
        """The limbs interface's recode of a padded input -> packed,
        counts."""
        n = sc.shape[0]
        nblk = -(-n // self.chunk[spec.name == "g2"])
        packed = torch.empty((spec.n_windows, n), dtype=torch.int16,
                             device=sc.device)
        counts = torch.empty((spec.n_windows, nblk, spec.n_buckets + 1),
                             dtype=torch.int32, device=sc.device)
        self.call(f"inf_msm_recode_{spec.name}", LIMBS_RECODE, sc, packed,
                  counts, n, nblk)
        return packed, counts

    def scan(self, counts):
        """The limbs interface's scan, in place -> totals."""
        nwin, nblk, bins = counts.shape
        totals = torch.empty((nwin, bins), dtype=torch.int32,
                             device=counts.device)
        self.call("inf_msm_scan", LIMBS_SCAN, counts, totals, nwin, nblk,
                  bins)
        return totals

    def padded(self, words, mask, rows):
        """The recode's padded, masked input as the limbs path made it:
        (N, 16) int64 limbs, or (N, 8) int32 words for a words reader."""
        n = words.shape[0]
        src = words if self.reads_words else words_to_limbs(words)
        sc = torch.zeros((rows, src.shape[1]), dtype=src.dtype,
                         device=words.device)
        sc[:n] = torch.where(mask.unsqueeze(-1), 0, src)
        return sc

    def path(self, words, mask, rows, spec, limbs=None):
        """The scalars' path -> (packed, offsets, totals). `limbs`: the
        words already converted (a prove converts the witness once)."""
        if self.iface == "words":
            with swapped(self):
                return M.layout_recode(words, spec, rows, mask)
        if limbs is not None and not self.reads_words:
            n = words.shape[0]
            sc = torch.zeros((rows, NLIMBS), dtype=torch.int64,
                             device=words.device)
            sc[:n] = torch.where(mask.unsqueeze(-1), 0, limbs)
        else:
            sc = self.padded(words, mask, rows)
        packed, counts = self.recode(sc, spec)
        return packed, counts, self.scan(counts)


def build(label: str, d: pathlib.Path, out: pathlib.Path,
          reads_words: bool) -> Variant:
    src = d / SOURCE
    lib = out / f"{re.sub(r'[^A-Za-z0-9]+', '_', label)}.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{d}", f"-I{kernels.CSRC}",
         "-shared", "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    print(f"[variants] {label}: {usage(proc.stdout + proc.stderr)}",
          flush=True)
    return Variant(ctypes.CDLL(str(lib)), chunks(src), reads_words)


@contextlib.contextmanager
def swapped(v: Variant):
    """This variant's library and layout chunks in the port's wrappers."""
    saved = kernels._lib, M.G1_SPEC.layout_chunk, M.G2_SPEC.layout_chunk
    kernels._lib = v.lib
    M.G1_SPEC.layout_chunk, M.G2_SPEC.layout_chunk = v.chunk
    try:
        yield
    finally:
        kernels._lib, M.G1_SPEC.layout_chunk, M.G2_SPEC.layout_chunk = saved


def alone_ms(fn) -> tuple[float, float]:
    """(the card's ms a call, the host's enqueue ms a call) of REPS calls
    of fn() queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / REPS
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS, host


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
            name = name.split("::")[-1][:40]
            out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / REPS
    return out


def scalar_words(rng, n: int, zeros: float):
    """(n, 8) standard-form words of scalars below r on the card, about
    zeros / 2 of them zero, and an infinity mask dropping about zeros / 2
    of the rows."""
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
    w[:, 7] &= 0x1FFFFFFF                              # below 2^253 < r
    w[rng.random(n) < zeros / 2] = 0
    mask = rng.random(n) < zeros / 2
    return (torch.from_numpy(w.astype(np.uint32).view(np.int32)).cuda(),
            torch.from_numpy(mask).cuda())


def compaction_inputs(rng, words, mask, rows, lanes: int, spec):
    """(edig, ept, K): this tree's layout and accumulation of the scalars
    over a table of random words below 2^252."""
    table = rng.integers(0, 1 << 32, size=(rows, spec.AW), dtype=np.int64)
    table[:, 7::8] &= 0x0FFFFFFF
    table = torch.from_numpy(table.astype(np.uint32).view(np.int32)).cuda()
    edig, ept = M.accumulate(*M.lane_layout(table, words, lanes, spec,
                                            mask=mask), spec)
    return edig, ept, spec.n_buckets + lanes + 2


def equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def turns(libs: dict, fns: dict, rounds: int, want=None, unchecked=()):
    """{label: (median card ms, median host ms, {grid: ms})} of each
    variant's fn in turns; each output checked against `want`."""
    times = {label: [] for label in fns}
    for label, fn in fns.items():
        got = fn()
        if want is not None and label not in unchecked and not equal(
                got, want):
            raise AssertionError(f"{label}: differs from this tree's")
    grids = {label: kernel_ms(fn) for label, fn in fns.items()}
    order = list(fns.items())
    for _ in range(rounds):
        for label, fn in order + order[::-1]:
            times[label].append(alone_ms(fn))
    out = {}
    for label, t in times.items():
        card = sorted(x[0] for x in t)[len(t) // 2]
        host = sorted(x[1] for x in t)[len(t) // 2]
        out[label] = (card, host, grids[label])
    return out


def report(title: str, res: dict) -> None:
    print(f"[variants] {title} ms: " + "; ".join(
        f"{label} {card:.4f} (host {host:.3f}; grids " + ", ".join(
            f"{k} {v:.4f}" for k, v in grids.items()) + ")"
        for label, (card, host, grids) in res.items()), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", metavar="LABEL=DIR")
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="LABEL=SOURCE")
    ap.add_argument("--unchecked", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--no-scatter", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("layout_variants: no CUDA device", file=sys.stderr)
        return 1
    kernels.library()
    print(f"[variants] this tree: {usage(kernels.BUILD_INFO['log'])}",
          flush=True)
    libs = {"this tree": Variant(kernels._lib, (M.G1_SPEC.layout_chunk,
                                                M.G2_SPEC.layout_chunk))}
    unchecked = set(args.unchecked)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(*v.split("=", 1), False) for v in args.variants]
        for spec in args.baseline:
            label, src = spec.split("=", 1)
            made = baseline(label, pathlib.Path(src), pathlib.Path(tmp))
            unchecked.add(f"{label} without count stores")
            jobs += [(k, str(v), k == f"{label} words")
                     for k, v in made.items()]
        with concurrent.futures.ThreadPoolExecutor(max(1, len(jobs))) as pool:
            built = pool.map(lambda j: build(j[0], pathlib.Path(j[1]),
                                             pathlib.Path(tmp), j[2]), jobs)
            libs.update(zip((j[0] for j in jobs), built))
        limbs_libs = {k: v for k, v in libs.items() if v.iface == "limbs"}
        rng = np.random.default_rng(SEED)
        inputs = {}
        for shape, (curve, rows, n, lanes, zeros) in SHAPES.items():
            spec = M.SPECS[curve]
            words, mask = scalar_words(rng, n, zeros)
            inputs[shape] = words, mask
            want = libs["this tree"].path(words, mask, rows, spec)
            res = turns(libs, {
                label: (lambda v=v: v.path(words, mask, rows, spec))
                for label, v in libs.items()}, args.rounds, want, unchecked)
            report(f"{shape} ({curve}, {n} scalars of {rows} rows) "
                   f"scalars' path", res)
            if limbs_libs:
                padded = {k: v.padded(words, mask, rows)
                          for k, v in limbs_libs.items()}
                report(f"{shape} recode alone", turns(limbs_libs, {
                    k: (lambda v=v, k=k: v.recode(padded[k], spec))
                    for k, v in limbs_libs.items()}, args.rounds))
                counts = next(iter(limbs_libs.values())).recode(
                    next(iter(padded.values())), spec)[1]
                pool = [counts.clone() for _ in range(len(limbs_libs) * (
                    (2 * args.rounds + 1) * (REPS + 1) + 1))]
                report(f"{shape} scan alone (counts {tuple(counts.shape)})",
                       turns(limbs_libs, {
                           k: (lambda v=v: v.scan(pool.pop()))
                           for k, v in limbs_libs.items()}, args.rounds))
                del pool
            cum = turns({}, {"torch.cumsum(counts, 1)":
                             lambda: torch.cumsum(want[1], 1)}, args.rounds)
            report(f"{shape} library yardstick", cum)
            if args.no_scatter:
                continue
            # an unchecked variant's offsets may be anything: no scatter
            checked = {k: v for k, v in libs.items() if k not in unchecked}
            outs = {label: v.path(words, mask, rows, spec)
                    for label, v in checked.items()}
            edig, ept, K = compaction_inputs(rng, words, mask, rows, lanes,
                                             spec)
            live = int((edig > 0).sum())

            def scatter(v, label):
                with swapped(v):
                    return M.layout_scatter(*outs[label], spec)

            def compaction(v):
                with swapped(v):
                    return M.compact(edig, ept, K)

            report(f"{shape} scatter", turns(checked, {
                label: (lambda v=v, label=label: scatter(v, label))
                for label, v in checked.items()}, args.rounds,
                scatter(libs["this tree"], "this tree")))
            report(f"{shape} compaction ({live} live of {edig.numel()} "
                   f"emissions)", turns(checked, {
                       label: (lambda v=v: compaction(v))
                       for label, v in checked.items()}, args.rounds,
                       compaction(libs["this tree"])))
            del edig, ept, outs

        # the five paths as one steady process prove issues them
        (wa, ma), (wb, mb), (wl, ml), (wh, mh), (w2, m2) = (
            inputs[s] for s in SHAPES)
        wb, wl, w2 = wa, wa[NPUB:], wa                # one witness
        ml = ml[:wl.shape[0]]

        def prove(v):
            limbs = words_to_limbs(wa) if v.iface == "limbs" else None
            hl = words_to_limbs(wh) if v.iface == "limbs" else None
            g1, g2 = M.G1_SPEC, M.G2_SPEC
            return (*v.path(wa, ma, 143360, g1, limbs),
                    *v.path(w2, m2, 141312, g2, limbs),
                    *v.path(wb, mb, 143360, g1, limbs),
                    *v.path(wl, ml, 143360, g1,
                            None if limbs is None else limbs[NPUB:]),
                    *v.path(wh, mh, 262144, g1, hl))

        report("a prove's five scalars' paths", turns(libs, {
            label: (lambda v=v: prove(v)) for label, v in libs.items()},
            args.rounds, prove(libs["this tree"]), unchecked))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[variants] card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
