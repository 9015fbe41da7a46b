"""The latency of one Montgomery product on a lone thread, on one card.

    python3 infimum_tpu_torch/bench/product_latency.py [--n N]

One thread of one block runs a dependent chain of N products x <- x y
(the next product waits on the last), and the chain of 2N; their
difference over N is one product's latency, the launch taken out. Each
product of `field.cuh`: the one-carry-chain `FqOutOfLine::mul` (out of
line, by value), the two-chain `FqTwoChains::mul` (out of line, by
value) and `two_chains::mul<FqParams>` inlined, and the Fr instances
`Fr::mul` and `two_chains::mul<FrParams>` inlined. Every chain's output
is checked against x (y / R)^N mod p in Python ints.

The probe's own source (below) includes `csrc/field.cuh` and is built by
nvcc into the gitignored `infimum_tpu_torch/build/`, keyed on its text,
the header's and the flags; it is no part of the kernel library. The
cross-rank sum's chain bound (`chip_smoke.py`, phase 11) reads the
two-chain latency from `latencies()`."""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from infimum_tpu_torch import kernels  # noqa: E402
from infimum_tpu_torch.ff.bn254 import FQ_MOD, FR_MOD  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>

#include "field.cuh"

namespace {
using namespace inf;

struct OneChainOutOfLine {
  using P = FqParams;
  static __device__ __forceinline__ Fq::E mul(Fq::E a, Fq::E b) {
    return FqOutOfLine::mul(a, b);
  }
};
struct TwoChainsOutOfLine {
  using P = FqParams;
  static __device__ __forceinline__ Fq::E mul(Fq::E a, Fq::E b) {
    return FqTwoChains::mul(a, b);
  }
};
struct TwoChainsInline {
  using P = FqParams;
  static __device__ __forceinline__ Fq::E mul(Fq::E a, Fq::E b) {
    return two_chains::mul<FqParams>(a, b);
  }
};
struct FrOneChainInline {
  using P = FrParams;
  static __device__ __forceinline__ Fr::E mul(Fr::E a, Fr::E b) {
    return Fr::mul(a, b);
  }
};
struct FrTwoChainsInline {
  using P = FrParams;
  static __device__ __forceinline__ Fr::E mul(Fr::E a, Fr::E b) {
    return two_chains::mul<FrParams>(a, b);
  }
};

template <class M>
__global__ void chain(const uint32_t* x0, const uint32_t* y0, uint32_t* out,
                      int n) {
  using E = typename Fp<typename M::P>::E;
  E x, y;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x.w[i] = x0[i];
    y.w[i] = y0[i];
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = M::mul(x, y);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = x.w[i];
}

template <class M>
int launch(const void* x, const void* y, void* out, int n, void* stream) {
  chain<M><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int probe_chain(int which, const void* x, const void* y,
                           void* out, int n, void* stream) {
  switch (which) {
    case 0: return launch<OneChainOutOfLine>(x, y, out, n, stream);
    case 1: return launch<TwoChainsOutOfLine>(x, y, out, n, stream);
    case 2: return launch<TwoChainsInline>(x, y, out, n, stream);
    case 3: return launch<FrOneChainInline>(x, y, out, n, stream);
    case 4: return launch<FrTwoChainsInline>(x, y, out, n, stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""
# (name, modulus) of probe_chain's `which`, in order
PRODUCTS = (("FqOutOfLine::mul (one chain)", FQ_MOD),
            ("FqTwoChains::mul (two chains)", FQ_MOD),
            ("two_chains::mul<FqParams> inlined", FQ_MOD),
            ("Fr::mul inlined (one chain)", FR_MOD),
            ("two_chains::mul<FrParams> inlined", FR_MOD))
N_DEFAULT = 4096


def build() -> ctypes.CDLL:
    """The probe's library, built once into build/ (keyed on the source,
    field.cuh and the flags)."""
    header = (kernels.CSRC / "field.cuh").read_bytes()
    key = hashlib.sha256(SOURCE.encode() + header
                         + " ".join(kernels.NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = kernels.BUILD_DIR / f"product_latency_{key}.so"
    if not lib.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(f".{os.getpid()}.cu")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(SOURCE)
        try:
            kernels._compile([kernels._nvcc(), *kernels.NVCC_FLAGS,
                              f"-I{kernels.CSRC}", "-shared", "-o", str(tmp),
                              str(src)])
            os.replace(tmp, lib)
        finally:
            src.unlink(missing_ok=True)
    out = ctypes.CDLL(str(lib))
    out.probe_chain.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    out.probe_chain.restype = ctypes.c_int
    return out


def _words(v: int, device) -> torch.Tensor:
    return torch.tensor([(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                        dtype=torch.int64).to(torch.int32).to(device)


def _int(t: torch.Tensor) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * i)
               for i, w in enumerate(t.tolist()))


def latencies(n: int = N_DEFAULT, reps: int = 5) -> dict:
    """{product name: microseconds a product} on card 0: the least over
    `reps` of (ms of a chain of 2n - ms of a chain of n) / n, each chain
    one launch between CUDA events. Raises where a chain's output is not
    x (y / R)^k mod p."""
    lib = build()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for which, (name, mod) in enumerate(PRODUCTS):
        x, y = 0x1234567 * 0x9E3779B97F4A7C15 % mod, (mod - 3) // 7
        xt, yt, ot = _words(x, dev), _words(y, dev), _words(0, dev)
        r_inv = pow(1 << 256, -1, mod)

        def run(k: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = lib.probe_chain(which, xt.data_ptr(), yt.data_ptr(),
                                 ot.data_ptr(), k, stream)
            end.record()
            if rc:
                raise RuntimeError(f"probe_chain {name}: cudaError {rc}")
            torch.cuda.synchronize()
            if _int(ot.cpu()) != x * pow(y * r_inv, k, mod) % mod:
                raise AssertionError(f"{name}: a chain of {k} products is "
                                     f"wrong")
            return start.elapsed_time(end)

        run(n)
        out[name] = min((run(2 * n) - run(n)) / n for _ in range(reps)) * 1e3
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=N_DEFAULT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("product_latency: no CUDA device", file=sys.stderr)
        return 1
    for name, us in latencies(args.n).items():
        print(f"[latency] {name}: {us:.4f} us a product on a lone thread "
              f"(chains of {args.n} and {2 * args.n})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
