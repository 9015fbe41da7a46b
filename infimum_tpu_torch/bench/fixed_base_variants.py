"""Variants of the fixed-base kernel's source (`csrc/fixed_base.cu`) against
this tree's, in turns on one card, at `generate_zkey`'s two calls.

    python3 infimum_tpu_torch/bench/fixed_base_variants.py [LABEL=SOURCE ...]
        [--patch NAME ...] [--rounds N]

First, as smoke phase 9 does, the process circuit's zkey
(ProcessMessages(10,2,1,2), phase 9's seed) is generated on the card with
each fixed-base call split into encoding, device part and decode
(`chip_smoke.FixedBaseSplit`), and this tree's decode (`decode_words`) of
each call's output is timed again by a host clock. The two calls' scalar
words (G1 and G2) are the cases below.

Variants: this tree's source; each LABEL=SOURCE given (a whole
`fixed_base.cu`, e.g. `git show <commit>:infimum_tpu_torch/csrc/
fixed_base.cu` written under the gitignored `.chip_scratch/`); each patch
of `PATCHES` named with `--patch` (`--patch all`: every one; "A+B"
applies A, then B), a text substitution of this tree's source. Each is
built by nvcc into a library of its own (all at once); its registers,
stack and spills, resident blocks an SM and waves at each call are
printed. A source whose kernel stores projective points (commit
8d98e63's and before) is told apart by its `store_proj` call: its (n,
3W) words are normalized by the plain version's `normalize_plain`
before they are compared. Every variant's
output of both calls must equal this tree's. Times are the card's ms a
call of REPS calls queued behind a spin kernel, the median of `--rounds`
rounds, each round running the variants forwards and then backwards."""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import random
import re
import subprocess
import sys
import tempfile
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from infimum_tpu_torch import kernels  # noqa: E402
from infimum_tpu_torch.client.e2e import REFERENCE_CONFIG  # noqa: E402
from infimum_tpu_torch.client.prover import ProverKeys  # noqa: E402
from infimum_tpu_torch.curve.proj import CURVES  # noqa: E402
from infimum_tpu_torch.groth16 import zkey as Z  # noqa: E402
from infimum_tpu_torch.msm import fixed_base as fb  # noqa: E402

SOURCE = "fixed_base.cu"
REPS = 10
# an SM of compute capability 9.0: registers, threads, blocks, shared memory
# (bytes, 1 KB of it reserved a block)
SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM = 65536, 2048, 32, 233472
MAIN_LOOP = """#pragma unroll 1
    for (int w = 0; w < kWindows; ++w) {
      const int d = s[0] & ((1u << kC) - 1);
#pragma unroll
      for (int k = 0; k < 7; ++k) s[k] = __funnelshift_r(s[k], s[k + 1], kC);
      s[7] >>= kC;
      if (d != 0) {
        const Affine<F> q = load_row<F>(table, (w << kC) + d);
        acc = rcb_add_mixed<F>(acc, q.x, q.y);
      }
    }
"""
# (a) the next nonzero window's row loaded before the current add
PREFETCH_LOOP = """    int w = 0;
    auto next_row = [&]() -> int {
      while (w < kWindows) {
        const int d = s[0] & ((1u << kC) - 1);
#pragma unroll
        for (int k = 0; k < 7; ++k) s[k] = __funnelshift_r(s[k], s[k + 1], kC);
        s[7] >>= kC;
        const int row = (w << kC) + d;
        ++w;
        if (d != 0) return row;
      }
      return -1;
    };
    int row = next_row();
    Affine<F> q;
    if (row >= 0) q = load_row<F>(table, row);
#pragma unroll 1
    while (row >= 0) {
      const int next = next_row();
      const Affine<F> nq = load_row<F>(table, next >= 0 ? next : row);
      acc = rcb_add_mixed<F>(acc, q.x, q.y);
      q = nq;
      row = next;
    }
"""
LAUNCH_BOUNDS = "__launch_bounds__(kFixedBlock, kMinBlocks<F>)"
MIN_BLOCKS = """template <class F>
constexpr int kMinBlocks = {g1};
template <>
constexpr int kMinBlocks<Fq2TwoChains> = {g2};
"""


def min_blocks(g1: int, g2: int) -> list[tuple[str, str]]:
    """Other __launch_bounds__ minima of resident blocks an SM, per curve:
    ptxas caps the registers to fit them."""
    return [(MIN_BLOCKS.format(g1=6, g2=4), MIN_BLOCKS.format(g1=g1, g2=g2))]


BLOCK = "constexpr int kFixedBlock = 128;"
# the root's inversion as a Fermat power: a^(p - 2) in Montgomery form is
# R^2 / a, and a product by the integer 1 leaves R / a
FERMAT = """__device__ __noinline__ Fq::E fermat_r_over(Fq::E a) {
  Fq::E r = Fq::one();
#pragma unroll 1
  for (int bit = 253; bit >= 0; --bit) {
    r = FqTwoChains::mul(r, r);
    const uint32_t e = FqParams::p(bit >> 5) - (bit < 32 ? 2u : 0u);
    if ((e >> (bit & 31)) & 1u) r = FqTwoChains::mul(r, a);
  }
  Fq::E one = Fq::zero();
  one.w[0] = 1;
  return FqTwoChains::mul(r, one);
}

}  // namespace fixed
"""
# the root's inversion as a binary extended Euclid that keeps its
# coefficients reduced (the epilogue's first version): u = a, v = p,
# x1 = R, x2 = 0 keep x1 a = u R and x2 a = v R mod p; each halving of u
# or v divides its coefficient by 2^k mod p (x + m p over 2^k, m = x
# (-p^-1) mod 2^k, then one conditional subtraction)
EUCLID = """__device__ __forceinline__ bool is_one(const Fq::E& a) {
  uint32_t acc = a.w[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < 8; ++i) acc |= a.w[i];
  return acc == 0;
}

__device__ __forceinline__ Fq::E div_pow2(const Fq::E& x, int k) {
  const uint32_t m = (x.w[0] * FqParams::INV) & ((1u << k) - 1);
  uint32_t t[9];
  t[0] = ptx::mad_lo_cc(m, FqParams::p(0), x.w[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j)
    t[j] = ptx::madc_lo_cc(m, FqParams::p(j), x.w[j]);
  t[8] = ptx::addc(0, 0);
  t[1] = ptx::mad_hi_cc(m, FqParams::p(0), t[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j)
    t[j + 1] = ptx::madc_hi_cc(m, FqParams::p(j), t[j + 1]);
  t[8] = ptx::madc_hi(m, FqParams::p(7), t[8]);
  Fq::E r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = __funnelshift_r(t[j], t[j + 1], k);
  return Fq::reduce_once(r);
}

__device__ __forceinline__ void strip(Fq::E& a, Fq::E& x) {
  while (!(a.w[0] & 1u) && !is_zero(a)) {
    const int k = a.w[0] ? __ffs(a.w[0]) - 1 : 31;
    shr(a, k);
    x = div_pow2(x, k);
  }
}

__device__ __noinline__ Fq::E euclid_r_over(Fq::E a) {
  Fq::E u = a, v, x1 = Fq::one(), x2 = Fq::zero();
  if (is_zero(u)) return x2;
#pragma unroll
  for (int i = 0; i < 8; ++i) v.w[i] = FqParams::p(i);
  strip(u, x1);
#pragma unroll 1
  for (int pass = 0; pass < 1024; ++pass) {
    if (is_one(u)) return x1;
    if (is_one(v)) return x2;
    Fq::E d;
    if (!sub_words(d, u, v)) {
      u = d;
      x1 = Fq::sub(x1, x2);
      strip(u, x1);
    } else {
      sub_words(v, v, u);
      x2 = Fq::sub(x2, x1);
      strip(v, x2);
    }
  }
  return Fq::zero();
}

}  // namespace fixed
"""
# G2's Fq2 product other ways: out of line by reference (Fq2OutOfLine's
# convention), or inline over the out-of-line two-chain Fq product
FQ2_BY_REFERENCE = """constexpr int kFixedBlock = 128;  // points sharing an inversion: = GROUP

struct Fq2ByReference : Fq2 {
  static __device__ __noinline__ E mul(const E& a, const E& b) {
    const Fq::E v0 = two_chains::mul<FqParams>(a.c0, b.c0);
    const Fq::E v1 = two_chains::mul<FqParams>(a.c1, b.c1);
    const Fq::E s = two_chains::mul<FqParams>(Fq::add(a.c0, a.c1),
                                              Fq::add(b.c0, b.c1));
    return {Fq::sub(v0, v1), Fq::sub(Fq::sub(s, v0), v1)};
  }

  static __device__ __forceinline__ E b3(const E& x) {
    constexpr uint32_t K0[8] = INF_G2_B3_C0;
    constexpr uint32_t K1[8] = INF_G2_B3_C1;
    return mul(x, {Fq::constant(K0), Fq::constant(K1)});
  }
};
"""
FQ2_INLINE = """constexpr int kFixedBlock = 128;  // points sharing an inversion: = GROUP

struct Fq2OverCalls : Fq2 {
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    const Fq::E v0 = FqTwoChains::mul(a.c0, b.c0);
    const Fq::E v1 = FqTwoChains::mul(a.c1, b.c1);
    const Fq::E s = FqTwoChains::mul(Fq::add(a.c0, a.c1),
                                     Fq::add(b.c0, b.c1));
    return {Fq::sub(v0, v1), Fq::sub(Fq::sub(s, v0), v1)};
  }

  static __device__ __forceinline__ E b3(const E& x) {
    constexpr uint32_t K0[8] = INF_G2_B3_C0;
    constexpr uint32_t K1[8] = INF_G2_B3_C1;
    return mul(x, {Fq::constant(K0), Fq::constant(K1)});
  }
};
"""
# text substitutions of this tree's source: {name: [(old, new), ...]},
# each old text replaced wherever it stands
PATCHES: dict[str, list[tuple[str, str]]] = {
    "prefetch": [(MAIN_LOOP, PREFETCH_LOOP)],
    "no minimum": [(LAUNCH_BOUNDS, "__launch_bounds__(kFixedBlock)")],
    "min blocks 5/3": min_blocks(5, 3),
    "min blocks 6/5": min_blocks(6, 5),
    "block 64": [(BLOCK, BLOCK.replace("128", "64"))],
    "block 256": [(BLOCK, BLOCK.replace("128", "256"))],
    "Fermat root": [("}  // namespace fixed\n", FERMAT),
                    ("fixed::inv_r_over(root)", "fixed::fermat_r_over(root)")],
    "Euclid root": [("}  // namespace fixed\n", EUCLID),
                    ("fixed::inv_r_over(root)", "fixed::euclid_r_over(root)")],
    "prefetch at G2": [(MAIN_LOOP, "    if constexpr (F::WORDS == 8) {\n"
                        + MAIN_LOOP + "    } else {\n" + PREFETCH_LOOP
                        + "    }\n")],
    "G2 product by reference": [(BLOCK + "  // points sharing an inversion: = GROUP\n",
                                 FQ2_BY_REFERENCE),
                                ("Fq2TwoChains", "Fq2ByReference")],
    "G2 product inline": [(BLOCK + "  // points sharing an inversion: = GROUP\n",
                           FQ2_INLINE),
                          ("Fq2TwoChains", "Fq2OverCalls")],
    # the product of commit 8d98e63 (field.cuh Fp::mul, one carry chain)
    "one carry chain": [("FqTwoChains", "FqOutOfLine"),
                        ("Fq2TwoChains", "Fq2OutOfLine")],
}


def patched(name: str) -> str:
    """This tree's source with the patch `name` applied ("A+B": A, then
    B)."""
    text = (kernels.CSRC / SOURCE).read_text()
    for old, new in (sub for part in name.split("+")
                     for sub in PATCHES[part]):
        if old not in text:
            raise ValueError(f"patch {name}: {old[:60]!r} is not in "
                             f"{SOURCE}")
        text = text.replace(old, new)
    return text


class Variant:
    """A built library: its kernels' resources by curve and whether it
    stores projective points."""

    def __init__(self, lib, text: str, log: str):
        self.lib = lib
        self.projective = "store_proj<F>(out" in text
        self.threads = int(re.search(r"constexpr int kFixedBlock = (\d+);",
                                     text).group(1))
        self.usage = {}
        for m in chip_smoke.RESOURCES.finditer(log):
            if "fixed_base" not in m.group(1):
                continue
            curve = "g2" if "Fq2" in m.group(1) else "g1"
            self.usage[curve] = dict(regs=int(m.group(5)),
                                     stack=int(m.group(2)),
                                     spills=(int(m.group(3)),
                                             int(m.group(4))),
                                     smem=int(m.group(6) or 0))
        for curve in ("g1", "g2"):
            fn = getattr(lib, f"inf_fixed_base_{curve}")
            fn.argtypes = kernels.KERNELS[f"fixed_base_{curve}"].argtypes
            fn.restype = ctypes.c_int

    def blocks_per_sm(self, curve: str) -> tuple[int, str]:
        """(resident blocks an SM, how it was found): CUDA's occupancy
        calculator where the library has the query, else from the
        registers and shared memory ptxas reports."""
        query = getattr(self.lib, f"inf_fixed_base_blocks_per_sm_{curve}",
                        None)
        if query is not None:
            query.argtypes, query.restype = [], ctypes.c_int
            return query(), "occupancy calculator"
        u = self.usage[curve]
        warps = -(-self.threads // 32)
        per_warp = -(-u["regs"] * 32 // 256) * 256
        limits = [SM_BLOCKS, SM_THREADS // self.threads,
                  SM_REGS // (per_warp * warps)]
        if u["smem"]:
            limits.append(SM_SMEM // (u["smem"] + 1024))
        return min(limits), "from the registers"

    def __call__(self, curve: str, sc: torch.Tensor, tab: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
        fn = getattr(self.lib, f"inf_fixed_base_{curve}")
        rc = fn(sc.data_ptr(), tab.data_ptr(), out.data_ptr(), sc.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"inf_fixed_base_{curve}: cudaError {rc}")
        return out

    def width(self, curve: str) -> int:
        return (3 if self.projective else 2) * fb.WORDS * CURVES[curve].fdims


def build(label: str, text: str, out: pathlib.Path) -> Variant:
    d = out / re.sub(r"[^A-Za-z0-9]+", "_", label)
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCE).write_text(text)
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{d}", f"-I{kernels.CSRC}",
         "-shared", "-o", str(d / "lib.so"), str(d / SOURCE)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return Variant(ctypes.CDLL(str(d / "lib.so")), text,
                   proc.stdout + proc.stderr)


def zkey_calls():
    """`generate_zkey` of the process circuit on the card, split as phase 9
    splits it: prints the split, returns the calls' records."""
    pc, _ = ProverKeys.circuits(**REFERENCE_CONFIG)
    with chip_smoke.FixedBaseSplit() as split:
        t0 = time.perf_counter()
        Z.generate_zkey(pc.cs, random.Random(chip_smoke.ZKEY_SEED),
                        device="cuda")
        gen_s = time.perf_counter() - t0
    print(f"[fixed_base] generate_zkey {gen_s:.3f} s; "
          + "; ".join(split.lines()), flush=True)
    return split.calls


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", metavar="LABEL=SOURCE")
    ap.add_argument("--patch", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fixed_base_variants: no CUDA device", file=sys.stderr)
        return 1
    names = list(PATCHES) if args.patch == ["all"] else args.patch
    texts = {"this tree": (kernels.CSRC / SOURCE).read_text()}
    texts.update((name, patched(name)) for name in names)
    for pair in args.sources:
        label, path = pair.split("=", 1)
        texts[label] = pathlib.Path(path).read_text()
    print(f"[fixed_base] card {chip_smoke.card_line()}", flush=True)
    kernels.library()
    calls = zkey_calls()
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
            built = dict(zip(texts, pool.map(
                lambda kv: build(kv[0], kv[1], pathlib.Path(tmp)),
                texts.items())))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for call in calls:
            name, sc, n = call["curve"], call["sc"], call["n"]
            curve = CURVES[name]
            tab = fb.table_words(name, "cuda:0")
            outs = {}
            for label, v in built.items():
                out = torch.empty((n, v.width(name)), dtype=torch.int32,
                                  device=sc.device)
                outs[label] = v(name, sc, tab, out)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fb.decode_words(outs["this tree"], curve)
            print(f"[fixed_base] {name.upper()} {n} scalars, "
                  f"{int((sc.view(torch.uint8) != 0).sum())} nonzero "
                  f"digits; this tree's decode: decode_words "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            if len(built) > 1:
                affine = {label: fb.normalize_plain(outs[label], curve)
                          if v.projective else outs[label]
                          for label, v in built.items()}
                for label, got in affine.items():
                    if not torch.equal(got, affine["this tree"]):
                        raise AssertionError(f"{label}: {name} output "
                                             f"differs from this tree's")
                del affine
            del outs
            times = {label: [] for label in built}
            order = list(built.items())
            for _ in range(args.rounds):
                for label, v in order + order[::-1]:
                    out = torch.empty((n, v.width(name)), dtype=torch.int32,
                                      device=sc.device)
                    ms, _, _ = chip_smoke.alone_ms(
                        lambda: v(name, sc, tab, out), REPS)
                    times[label].append(ms)
            for label, v in built.items():
                t = sorted(times[label])
                u = v.usage[name]
                blocks, how = v.blocks_per_sm(name)
                waves = n / (blocks * v.threads * sms)
                print(f"[fixed_base] {name.upper()} {label}: "
                      f"{t[len(t) // 2]:.4f} ms (of "
                      f"{', '.join(f'{x:.4f}' for x in times[label])}); "
                      f"{u['regs']} registers, {u['stack']} B stack, "
                      f"{u['spills'][0]}/{u['spills'][1]} B spill "
                      f"stores/loads, {u['smem']} B shared; {blocks} blocks "
                      f"of {v.threads} an SM ({how}), {waves:.2f} waves"
                      f"{'; projective output' if v.projective else ''}",
                      flush=True)
    print(f"[fixed_base] card {chip_smoke.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
