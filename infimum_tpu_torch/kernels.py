"""Build and bind the port's CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` for `sm_90a` into one shared
library with a plain C interface, at first use, into `build/` (kept out of
git). Each `.cu` becomes an object keyed on a hash of its source, the local
headers it includes and the flags; the library is linked from the objects
and keyed on their keys. So an edited source rebuilds its own object only,
and an unchanged library is loaded as it is. The library is bound with
`ctypes`: pointers and the stream go as `c_void_p`, sizes as `c_int`. Each
C entry point launches on the stream it is given and returns
`cudaGetLastError()`, and the wrapper raises when that is not 0. A launch
goes to the card its tensors lie on, with that card current, whichever
card the calling thread had current.

`Kernel.launches` counts the launches of one kernel instance (an MSM
kernel for one curve, the MSM layout's recode (its scan in the same
launch) and scatter and its compaction, the Poseidon permutation for
every width, its measured variants apart; the H pipeline's row
evaluation, NTT tile and pass launches and pointwise step; the fixed-base
multiply of setup for each curve; the sharded MSM's cross-rank sum for
each curve), so a run can
show that its main path went through the kernel. Nothing here is
imported or built unless a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCES = ("msm_accum.cu", "msm_weighted.cu", "msm_layout.cu",
           "poseidon_perm.cu", "fr_ntt.cu", "fr_rows.cu", "fixed_base.cu",
           "point_sum.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--resource-usage")


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, symbol: str, nptr: int, nint: int):
        self.symbol = symbol
        self.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [
            ctypes.c_void_p]
        self.launches = 0

    def __call__(self, *args):
        """Launch on the tensors' card, on its current stream; `args` are
        tensors (None for a null pointer) then ints. The tensors must all
        lie on one card."""
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"{self.symbol}: want tensors on one card, got "
                             f"{sorted(map(str, devices))}")
        dev = devices.pop()
        fn = getattr(library(), self.symbol)
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(dev):
            rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {rc}")
        self.launches += 1


KERNELS = {
    "msm_accum_g1": Kernel("inf_msm_accum_g1", 6, 3),
    "msm_accum_g2": Kernel("inf_msm_accum_g2", 6, 3),
    "msm_weighted_g1": Kernel("inf_msm_weighted_g1", 4, 2),
    "msm_weighted_g2": Kernel("inf_msm_weighted_g2", 4, 2),
    "msm_recode_g1": Kernel("inf_msm_recode_g1", 5, 3),
    "msm_recode_g2": Kernel("inf_msm_recode_g2", 5, 3),
    "msm_scatter_g1": Kernel("inf_msm_scatter_g1", 6, 2),
    "msm_scatter_g2": Kernel("inf_msm_scatter_g2", 6, 2),
    "msm_compact_g1": Kernel("inf_msm_compact_g1", 5, 4),
    "msm_compact_g2": Kernel("inf_msm_compact_g2", 5, 4),
    "poseidon_perm": Kernel("inf_poseidon_perm", 6, 3),
    "poseidon_perm_variant": Kernel("inf_poseidon_perm_variant", 6, 4),
    "fr_rows": Kernel("inf_fr_rows", 8, 2),
    "fr_ntt_tile": Kernel("inf_fr_ntt_tile", 6, 4),
    "fr_ntt_pass": Kernel("inf_fr_ntt_pass", 4, 4),
    "fr_pointwise": Kernel("inf_fr_pointwise", 5, 1),
    "fixed_base_g1": Kernel("inf_fixed_base_g1", 3, 1),
    "fixed_base_g2": Kernel("inf_fixed_base_g2", 3, 1),
    "point_sum_g1": Kernel("inf_point_sum_g1", 3, 2),
    "point_sum_g2": Kernel("inf_point_sum_g2", 3, 2),
}

# the last build of this process: {"seconds", "path", "log", "sources"}
# (log holds nvcc's --resource-usage report: registers, spills, shared
# memory; sources maps each .cu to its compile seconds, None when cached)
BUILD_INFO: dict = {}
_lib = None


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _object_key(src: str) -> str:
    """Hash of a source, the local headers it includes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [src], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        text = (CSRC / name).read_bytes()
        h.update(name.encode() + b"\0" + text)
        todo += re.findall(r'#include "([^"]+)"', text.decode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def _compile(cmd) -> tuple[float, str]:
    """Run one nvcc command; (seconds, output), raising on a failure."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}")
    return time.perf_counter() - t0, proc.stdout


def build() -> pathlib.Path:
    """Compile csrc/ into build/: each .cu whose object is not built yet,
    all in parallel, then the library from the objects unless it exists."""
    keys = {src: _object_key(src) for src in SOURCES}
    tag = hashlib.sha256("".join(keys.values()).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libinfimum_torch_{tag}.so"
    if out.exists():
        BUILD_INFO.update(seconds=0.0, path=str(out), log="(cached)",
                          sources=dict.fromkeys(SOURCES))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = {src: BUILD_DIR / f"{src[:-3]}_{key}.o" for src, key in keys.items()}
    todo = [src for src, obj in objs.items() if not obj.exists()]
    tmps = {src: objs[src].with_suffix(f".{os.getpid()}.tmp.o") for src in todo}
    with concurrent.futures.ThreadPoolExecutor(max(1, len(todo))) as pool:
        done = dict(zip(todo, pool.map(_compile, (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmps[src]), str(CSRC / src)]
            for src in todo))))
    for src in todo:
        os.replace(tmps[src], objs[src])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _, link_log = _compile([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs.values())])
    os.replace(tmp, out)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, path=str(out),
        log="".join(log for _, log in done.values()) + link_log,
        sources={src: done[src][0] if src in done else None
                 for src in SOURCES})
    return out


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for k in KERNELS.values():
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def query(symbol: str, *args: int) -> int:
    """An int the library reports about a kernel (a block's threads,
    resident blocks an SM), raising where it reports -1."""
    fn = getattr(library(), symbol)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
    n = fn(*args)
    if n < 0:
        raise RuntimeError(f"{symbol}{args} failed")
    return n


def accum_occupancy(curve: str) -> tuple[int, int]:
    """(threads a block, resident blocks an SM) of the accumulation
    kernel's instance for `curve` on the current card (CUDA's occupancy
    calculator)."""
    return (query("inf_msm_accum_block"),
            query(f"inf_msm_accum_blocks_per_sm_{curve}"))


def recode_blocks_per_sm(curve: str) -> int:
    """Resident blocks an SM of the MSM layout's recode instance for
    `curve` on the current card (CUDA's occupancy calculator, its shared
    memory allowed): its cooperative grid is at most this times the SMs."""
    return query(f"inf_msm_recode_blocks_per_sm_{curve}")


def scatter_blocks_per_sm(curve: str) -> int:
    """Resident blocks an SM of the MSM layout's scatter instance for
    `curve` on the current card (CUDA's occupancy calculator, its shared
    memory allowed)."""
    return query(f"inf_msm_scatter_blocks_per_sm_{curve}")


def fixed_base_blocks_per_sm(curve: str) -> int:
    """Resident blocks an SM of the fixed-base multiply's instance for
    `curve` on the current card (CUDA's occupancy calculator, its shared
    product tree included)."""
    return query(f"inf_fixed_base_blocks_per_sm_{curve}")


def perm_main_variant() -> int:
    """The Poseidon kernel's main instance as `inf_poseidon_perm_variant`
    numbers its variants (bit 0: product out of line; bit 1: tables in
    shared memory)."""
    return query("inf_poseidon_perm_main_variant")
