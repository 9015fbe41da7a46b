"""Variants of the H stage's kernel sources against this tree's, in turns on
one card.

    python3 infimum_tpu_torch/bench/h_variants.py LABEL=DIR [LABEL=DIR ...]
        [--unchecked LABEL] [--rounds N]

Each DIR holds its own `fr_rows.cu` and/or `fr_ntt.cu` with this tree's C
interface (`kernels.KERNELS`); a source it lacks is taken from this tree,
and its includes resolve in DIR first, then in `csrc/`. Each variant is
built with nvcc into a library of its own (all at once), its kernels'
registers and spills are printed, and then every case below runs on each
library in turn, this tree's first, through the port's own wrappers:
the library is swapped in for the variant's turn, and `ntt.TILE_LOG` and
`ntt.PASS_LOG` set to the `kTileLog` and `kPassLog` of its `fr_ntt.cu`
(a copy with `kPassLog = 1` runs one pass launch a stage above the tile,
the launch structure of the stage kernel the pass replaced). Cases, at
the reference circuits' shapes (ProcessMessages(10,2,1,2) at 2^18,
TallyVotes(10,1,2) at 2^14), random inputs from a seed: the row launch,
the tile launch of the coset NTT (B = 3, the coset powers), its pass
launches alone (in place on a scratch copy of the tile's output; their
output checked on a fresh copy), the whole coset NTT and the whole coset
iNTT of a.b - c (B = 1, product mode), and the whole `h_rows`. Every
output but the lone tile's must equal this tree's (a variant named with
`--unchecked` computes something else on purpose, and is only timed).
Times are CUDA-event ms, the median of `--rounds` rounds, each round
running the variants forwards and then backwards."""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
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
from infimum_tpu_torch.client.e2e import REFERENCE_CONFIG  # noqa: E402
from infimum_tpu_torch.client.prover import ProverKeys  # noqa: E402
from infimum_tpu_torch.groth16 import groth16 as g16  # noqa: E402
from infimum_tpu_torch.groth16 import rowval as RV  # noqa: E402
from infimum_tpu_torch.ntt import ntt as N  # noqa: E402

H_SOURCES = ("fr_rows.cu", "fr_ntt.cu")
SEED = 20261017
RESOURCES = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
    r"spill stores, (\d+) bytes spill loads\nptxas info\s*: Used (\d+) "
    r"registers")


def source_logs(source: pathlib.Path) -> tuple[int, int]:
    """(kTileLog, kPassLog) of an `fr_ntt.cu`."""
    text = source.read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
                 for name in ("kTileLog", "kPassLog"))


def build(label: str, d: pathlib.Path, out: pathlib.Path):
    """(library, (tile log, pass log)) of a variant directory."""
    srcs = [d / s if (d / s).exists() else kernels.CSRC / s
            for s in H_SOURCES]
    lib = out / f"{re.sub(r'[^A-Za-z0-9]+', '_', label)}.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{d}", f"-I{kernels.CSRC}",
         "-shared", "-o", str(lib), *map(str, srcs)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    usage = "; ".join(
        f"{m.group(1)}: {m.group(5)} registers, {m.group(3)}/{m.group(4)} B "
        f"spill stores/loads"
        for m in RESOURCES.finditer(proc.stdout + proc.stderr)
        if "fr_" in m.group(1))
    print(f"[variants] {label}: {usage}", flush=True)
    so = ctypes.CDLL(str(lib))
    for k in kernels.KERNELS.values():
        if k.symbol.startswith("inf_fr_"):
            fn = getattr(so, k.symbol)
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    return so, source_logs(srcs[1])


@contextlib.contextmanager
def swapped(lib, logs: tuple[int, int]):
    """This variant's library, tile and pass size in the port's
    wrappers."""
    saved = kernels._lib, N.TILE_LOG, N.PASS_LOG
    kernels._lib, (N.TILE_LOG, N.PASS_LOG) = lib, logs
    try:
        yield
    finally:
        kernels._lib, N.TILE_LOG, N.PASS_LOG = saved


def ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_words(rng, *shape) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=shape + (8,), dtype=np.int64)
    w[..., 7] &= 0x0FFFFFFF                           # below r
    return torch.from_numpy(w.astype(np.int32)).cuda()


def cases(cs, rng):
    """{case: fn() or (fn(), check())} at one circuit's shape: check's
    output is compared, fn is timed (fn itself where there is no check)."""
    m = g16._domain_size(cs)
    logm = m.bit_length() - 1
    sp = g16.sparse_rows(cs, "cuda")
    sp.partition(m)
    ww = random_words(rng, cs.num_vars)
    abc = random_words(rng, 3, m)
    dev = N.device_key("cuda")
    tw, _ = N.word_tables(logm, False, dev)
    pre = N.coset_words(logm, g16.COSET_GEN, False, dev)
    post = (N.fr_const(N.fr_inv(m), dev),
            N.coset_words(logm, g16.COSET_GEN, True, dev))
    tiled = N.ntt_tile(abc, logm, tw, pre)
    scratch = tiled.clone()

    def passes(x):
        for s0, s1 in N.pass_plan(logm):
            x = N.ntt_pass(x, logm, s0, s1, tw)
        return x

    return {
        f"fr_rows ({sp.nnz} terms, longest row {sp.longest})":
            lambda: RV.rows_words(sp, ww, m),
        "tile of the coset NTT, B = 3": lambda: N.ntt_tile(abc, logm, tw, pre),
        "passes of the coset NTT, B = 3": (lambda: passes(scratch),
                                           lambda: passes(tiled.clone())),
        "coset NTT, B = 3": lambda: N.ntt_words(abc, logm, pre=pre),
        "coset iNTT of a.b - c, B = 1": lambda: N.ntt_words(
            abc, logm, True, None, *post, mode=N.PRODUCT),
        "h_rows": lambda: g16.h_rows(cs, ww, "cuda"),
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", metavar="LABEL=DIR")
    ap.add_argument("--unchecked", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h_variants: no CUDA device", file=sys.stderr)
        return 1
    kernels.library()
    libs = {"this tree": (kernels._lib, (N.TILE_LOG, N.PASS_LOG))}
    with tempfile.TemporaryDirectory() as tmp:
        pairs = [v.split("=", 1) for v in args.variants]
        with concurrent.futures.ThreadPoolExecutor(len(pairs)) as pool:
            built = pool.map(lambda p: build(p[0], pathlib.Path(p[1]),
                                             pathlib.Path(tmp)), pairs)
            libs.update(zip((p[0] for p in pairs), built))
        pc, tc = ProverKeys.circuits(**REFERENCE_CONFIG)
        rng = np.random.default_rng(SEED)
        for shape, cs in (("process", pc.cs), ("tally", tc.cs)):
            for case, fns in cases(cs, rng).items():
                fn, check = fns if isinstance(fns, tuple) else (fns, fns)
                want = check()
                for label, (lib, logs) in libs.items():
                    with swapped(lib, logs):
                        got = check()
                    lone = case.startswith(("tile", "passes")) and \
                        logs[0] != N.TILE_LOG
                    if label not in args.unchecked and not lone and \
                            not torch.equal(got, want):
                        raise AssertionError(f"{label}: {shape} {case} "
                                             f"differs from this tree's")
                times = {label: [] for label in libs}
                order = list(libs.items())
                for _ in range(args.rounds):
                    for label, (lib, logs) in order + order[::-1]:
                        with swapped(lib, logs):
                            times[label].append(ms(fn))
                print(f"[variants] {shape} {case} ms: " + "; ".join(
                    f"{label} (tile 2^{libs[label][1][0]}, passes of "
                    f"{libs[label][1][1]} stages) "
                    f"{sorted(t)[len(t) // 2]:.4f}"
                    for label, t in times.items()), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[variants] card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
