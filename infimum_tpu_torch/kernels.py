"""Build and bind the port's CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` for `sm_90a` into one shared
library with a plain C interface, at first use, into `build/` (kept out of
git), under a name keyed on a hash of the sources: an edited source gets a
fresh build, an unchanged one is loaded as it is. The library is bound with
`ctypes`: pointers and the stream go as `c_void_p`, sizes as `c_int`. Each
C entry point launches on the stream it is given and returns
`cudaGetLastError()`, and the wrapper raises when that is not 0.

`Kernel.launches` counts the launches of one kernel for one curve, so a run
can show that its main path went through the kernel. Nothing here is
imported or built unless a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCES = ("field.cuh", "msm_accum.cu", "msm_weighted.cu")
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
        """Launch on the current stream; `args` are tensors then ints."""
        fn = getattr(library(), self.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        rc = fn(*ptrs, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {rc}")
        self.launches += 1


KERNELS = {
    "msm_accum_g1": Kernel("inf_msm_accum_g1", 5, 3),
    "msm_accum_g2": Kernel("inf_msm_accum_g2", 5, 3),
    "msm_weighted_g1": Kernel("inf_msm_weighted_g1", 3, 2),
    "msm_weighted_g2": Kernel("inf_msm_weighted_g2", 3, 2),
}

# the last build of this process: {"seconds", "path", "log"} (log holds
# nvcc's --resource-usage report: registers, spills, shared memory)
BUILD_INFO: dict = {}
_lib = None


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def _run(cmds):
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode})"
                               f":\n{out}")
        logs.append(out)
    return "".join(logs)


def build() -> pathlib.Path:
    """Compile csrc/ into build/ unless this source hash is built already:
    each .cu to an object in parallel, then one shared library."""
    tag = _source_hash()
    out = BUILD_DIR / f"libinfimum_torch_{tag}.so"
    if out.exists():
        BUILD_INFO.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, cmds = [], []
    for src in (s for s in SOURCES if s.endswith(".cu")):
        obj = BUILD_DIR / f"{src[:-3]}_{tag}.{os.getpid()}.o"
        objs.append(str(obj))
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)])
    log = _run(cmds)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log += _run([[nvcc, "-shared", "-o", str(tmp), *objs]])
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(out),
                      log=log)
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
