"""Signed-digit Pippenger MSM for BN254 G1 and G2, on two CUDA kernels.

Counterpart of `infimum_tpu/msm/pallas_msm.py:403-553`. Per window, with
all windows batched into one launch of each kernel:

  1. torch (`lane_layout`): signed c-bit recode of the scalars, a batched
     per-window sort by |digit|, the gather of the points into the
     limb-major lane layout [window][t][word][lane]; lane l owns the sorted
     range [l*T, (l+1)*T).
  2. kernel `msm_accum` (csrc/msm_accum.cu): run-emission accumulation.
  3. torch: compaction. The sorted order bounds the live emissions per
     window by n_buckets + L + 2, so a flag / cumsum / scatter packs them.
  4. kernel `msm_weighted` (csrc/msm_weighted.cu): sum of digit * point
     over each window's emissions.

The window sums combine on the host (Horner, c doublings per window).
Inside the pipeline a field element is 8 32-bit words (int32 tensors,
the bit pattern of uint32); at the public functions it is 16 16-bit limbs,
Montgomery R = 2^256 in both, so the values are the same integers.

Each kernel wrapper launches its kernel for a CUDA tensor and raises for
any other device but the CPU; for a CPU tensor it runs the plain version
beside it, which computes the same emissions and window sums in torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

from .. import kernels
from ..curve.proj import CURVES
from ..ff.fp import NLIMBS, ints_to_tensor
from infimum_tpu.ff.bn254 import FR_MOD

# lane counts on the card: each (window, lane) thread walks T = N / L
# entries; at the poll's shapes (130k-260k points) T is 36-70
LANES_MAX = {"g1": 4096, "g2": 2048}


class CurveSpec:
    """Static parameters binding the pipeline to G1 or G2."""

    def __init__(self, name: str, c_bits: int):
        self.name = name
        self.curve = CURVES[name]
        self.c_bits = c_bits
        self.n_buckets = 1 << (c_bits - 1)
        self.n_windows = -(-254 // c_bits)
        self.RF = NLIMBS * (2 if name == "g2" else 1)  # 16-bit limbs per coord
        self.AF, self.PR = 2 * self.RF, 3 * self.RF
        self.AW, self.PW = self.AF // 2, self.PR // 2    # 32-bit words


G1_SPEC = CurveSpec("g1", 13)     # 20 windows
G2_SPEC = CurveSpec("g2", 10)     # 26 windows
SPECS = {"g1": G1_SPEC, "g2": G2_SPEC}


def msm_lanes(n: int, curve: str) -> int:
    """Power-of-two lane count giving about 32 entries per lane."""
    lanes = 8
    while lanes * 32 < n and lanes < LANES_MAX[curve]:
        lanes *= 2
    return lanes


# -- limb <-> word packing ----------------------------------------------------------

def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """(..., 2k) int64 16-bit limbs -> (..., k) int32 words."""
    w = a[..., 0::2] | (a[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> (..., 2k) int64 16-bit limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], -1).flatten(-2)


def _point_words(p, spec: CurveSpec) -> torch.Tensor:
    """Projective (X, Y, Z) of (*batch, field shape) -> (*batch, PW) words."""
    nb = p[0].dim() - spec.curve.fdims
    return limbs_to_words(torch.cat([c.flatten(nb) for c in p], -1))


def _words_point(w: torch.Tensor, spec: CurveSpec, ncoord: int):
    """(*batch, ncoord * W) words -> tuple of ncoord (*batch, field shape)."""
    limbs = words_to_limbs(w).unflatten(-1, (ncoord, *spec.curve.fshape()))
    return tuple(limbs.select(w.dim() - 1, i) for i in range(ncoord))


# -- signed recode ------------------------------------------------------------

def recode(sc: torch.Tensor, spec: CurveSpec):
    """(N, 16) standard-form scalar limbs, reduced mod r -> (nwin, N) int32
    digit magnitudes and signs, least significant window first.

    Raw c-bit digit plus carry-in d in [0, 2^c]; d > 2^(c-1) becomes
    digit d - 2^c with carry-out 1, kept as (magnitude 2^c - d, sign 1).
    r < 2^254, so the top window never carries out."""
    c, half = spec.c_bits, spec.n_buckets
    sc = tnf.pad(sc, (0, 1))
    carry = torch.zeros(sc.shape[0], dtype=torch.int64, device=sc.device)
    mags, sgns = [], []
    for w in range(spec.n_windows):
        limb, sh = divmod(c * w, 16)
        comb = sc[:, limb] | (sc[:, limb + 1] << 16)
        d = ((comb >> sh) & ((1 << c) - 1)) + carry
        neg = d > half
        mags.append(torch.where(neg, 2 * half - d, d))
        sgns.append(neg)
        carry = neg.to(torch.int64)
    return (torch.stack(mags).to(torch.int32),
            torch.stack(sgns).to(torch.int32))


# -- kernel 1: run-emission accumulation --------------------------------------------

def _check(t: torch.Tensor, shape, name: str):
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want contiguous int32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def accumulate(sdig, ssgn, spts, spec: CurveSpec):
    """sdig, ssgn (nwin, T, L) int32; spts (nwin, T, AW, L) int32 words ->
    edig (nwin, T+1, L) int32, ept (nwin, T+1, PW, L) int32 words.

    Emission t < T is the run that ended before entry t (digit 0: none or
    dead); emission T is each lane's final run. Dead emissions' points are
    unspecified."""
    if spts.device.type == "cuda":
        nwin, T, AW, L = spts.shape
        _check(sdig, (nwin, T, L), "sdig")
        _check(ssgn, (nwin, T, L), "ssgn")
        _check(spts, (nwin, T, spec.AW, L), "spts")
        edig = torch.empty((nwin, T + 1, L), dtype=torch.int32,
                           device=spts.device)
        ept = torch.empty((nwin, T + 1, spec.PW, L), dtype=torch.int32,
                          device=spts.device)
        kernels.KERNELS[f"msm_accum_{spec.name}"](
            sdig, ssgn, spts, edig, ept, nwin, T, L)
        return edig, ept
    if spts.device.type != "cpu":
        raise ValueError(f"no msm_accum kernel for {spts.device}")
    return accumulate_plain(sdig, ssgn, spts, spec)


def accumulate_plain(sdig, ssgn, spts, spec: CurveSpec):
    """Plain torch version of the accumulation kernel."""
    curve, F = spec.curve, spec.curve.F
    nwin, T, _, L = spts.shape
    dev = spts.device
    pts = _words_point(spts.transpose(2, 3), spec, 2)  # (nwin, T, L, field)
    acc = curve.infinity((nwin, L), dev)
    one = curve.one((nwin, L), dev)
    ad = torch.zeros((nwin, L), dtype=torch.int64, device=dev)
    edig, ept = [], []
    for t in range(T):
        d = sdig[:, t].to(torch.int64)
        px, py = pts[0][:, t], pts[1][:, t]
        py = F.select(ssgn[:, t] != 0, F.neg(py), py)
        summed = curve.add_mixed(acc, (px, py))
        same = d == ad
        edig.append(torch.where(same, 0, ad))
        ept.append(_point_words(acc, spec))
        acc = curve.select(same, summed, (px, py, one))
        ad = d
    edig.append(ad)
    ept.append(_point_words(acc, spec))
    return (torch.stack(edig, 1).to(torch.int32),
            torch.stack(ept, 1).transpose(2, 3).contiguous())


# -- compaction ---------------------------------------------------------------------

def compact(edig, ept, K: int):
    """Pack each window's live emissions (digit > 0) into K slots:
    (nwin, K) int32 digits and (nwin, PW, K) int32 words, zero-padded."""
    nwin, T1, PW, L = ept.shape
    flat = edig.reshape(nwin, T1 * L)
    flags = flat > 0
    dest = torch.where(flags, flags.cumsum(1) - 1, K)   # slot K: dropped
    cdig = torch.zeros((nwin, K + 1), dtype=torch.int32, device=edig.device)
    cdig.scatter_(1, dest, flat)
    rows = ept.transpose(1, 2).reshape(nwin, PW, T1 * L)
    cpts = torch.zeros((nwin, PW, K + 1), dtype=torch.int32,
                       device=edig.device)
    cpts.scatter_(2, dest.unsqueeze(1).expand(-1, PW, -1), rows)
    return cdig[:, :K].contiguous(), cpts[:, :, :K].contiguous()


# -- kernel 2: weighted bucket reduction ----------------------------------------------

def weighted_sum(cdig, cpts, spec: CurveSpec):
    """cdig (nwin, K) int32, cpts (nwin, PW, K) int32 words -> (nwin, PW)
    int32 words: per window the projective sum of digit * point."""
    if cpts.device.type == "cuda":
        nwin, K = cdig.shape
        _check(cdig, (nwin, K), "cdig")
        _check(cpts, (nwin, spec.PW, K), "cpts")
        out = torch.empty((nwin, spec.PW), dtype=torch.int32,
                          device=cpts.device)
        kernels.KERNELS[f"msm_weighted_{spec.name}"](cdig, cpts, out, nwin, K)
        return out
    if cpts.device.type != "cpu":
        raise ValueError(f"no msm_weighted kernel for {cpts.device}")
    return weighted_sum_plain(cdig, cpts, spec)


def weighted_sum_plain(cdig, cpts, spec: CurveSpec):
    """Plain torch version of the weighted kernel: c-bit double-and-add of
    every live entry, then a halving tree over the entries. Compaction puts
    the live entries first, so only the longest live prefix is computed."""
    curve = spec.curve
    nwin = cdig.shape[0]
    dev = cdig.device
    k = int((cdig != 0).sum(1).max())
    if k == 0:
        return _point_words(curve.infinity((nwin,), dev), spec)
    d = cdig[:, :k].to(torch.int64)
    pt = _words_point(cpts[:, :, :k].transpose(1, 2), spec, 3)
    part = curve.infinity((nwin, k), dev)
    for b in range(spec.c_bits - 1, -1, -1):
        part = curve.add(part, part)
        part = curve.select(((d >> b) & 1) == 1, curve.add(part, pt), part)
    while part[0].shape[1] > 1:
        n = part[0].shape[1]
        if n % 2:
            inf = curve.infinity((nwin, 1), dev)
            part = tuple(torch.cat([c, i], 1) for c, i in zip(part, inf))
            n += 1
        part = curve.add(tuple(c[:, :n // 2] for c in part),
                         tuple(c[:, n // 2:] for c in part))
    return _point_words(tuple(c[:, 0] for c in part), spec)


# -- orchestration ------------------------------------------------------------------

def lane_layout(rows, sc, lanes: int, spec: CurveSpec):
    """Recode, sort each window by |digit| and gather the points: the
    accumulation kernel's inputs (sdig, ssgn, spts) for rows (N, AF) and
    scalars (N, 16), N = T * lanes; lane l owns sorted entries
    [l*T, (l+1)*T)."""
    N = rows.shape[0]
    if N % lanes or sc.shape[0] != N:
        raise ValueError(f"{N} rows do not fill {lanes} lanes")
    T, L, nwin = N // lanes, lanes, spec.n_windows
    mags, sgns = recode(sc, spec)
    sdig, order = torch.sort(mags, dim=1)
    ssgn = sgns.gather(1, order)
    spts = limbs_to_words(rows)[order]                 # (nwin, N, AW)
    return (sdig.view(nwin, L, T).transpose(1, 2).contiguous(),
            ssgn.view(nwin, L, T).transpose(1, 2).contiguous(),
            spts.view(nwin, L, T, spec.AW).permute(0, 2, 3, 1).contiguous())


def msm_rows_async(rows, sc, lanes: int, curve: str = "g1") -> torch.Tensor:
    """rows (N, AF) affine Montgomery limbs, sc (N, 16) standard-form scalar
    limbs reduced mod r, N = T * lanes -> (nwin, PR) window-sum limbs.

    Dispatches the whole pipeline without a host wait on the card."""
    spec = SPECS[curve]
    edig, ept = accumulate(*lane_layout(rows, sc, lanes, spec), spec)
    cdig, cpts = compact(edig, ept, spec.n_buckets + lanes + 2)
    return words_to_limbs(weighted_sum(cdig, cpts, spec))


def decode_windows(wins, curve: str = "g1"):
    """(nwin, PR) window-sum limbs -> host affine points / None."""
    spec = SPECS[curve]
    w = torch.as_tensor(wins).reshape(-1, 3, *spec.curve.fshape())
    return spec.curve.decode((w[:, 0], w[:, 1], w[:, 2]))


def combine_window_points(wins, curve: str = "g1"):
    """(nwin, PR) window sums (least significant first) -> one affine point
    via Horner with the host curve ops."""
    spec = SPECS[curve]
    host = spec.curve
    total = None
    for pt in reversed(decode_windows(wins, curve)):
        if total is not None:
            for _ in range(spec.c_bits):
                total = host.host_double(total)
        total = host.host_add(total, pt)
    return total


def encode_rows(points, lanes: int, curve: str = "g1", device="cpu"):
    """Host affine points (no infinities) -> (Npad, AF) rows, zero rows
    padding them to a multiple of `lanes`."""
    spec = SPECS[curve]
    n = len(points)
    npad = lanes * max(1, math.ceil(n / lanes))
    rows = torch.zeros((npad, spec.AF), dtype=torch.int64, device=device)
    rows[:n] = spec.curve.encode_affine(points, device).reshape(n, spec.AF)
    return rows


def encode_inputs(points, scalars, lanes: int, curve: str = "g1",
                  device="cpu"):
    """Host points / ints -> ((Npad, AF) rows, (Npad, 16) scalar limbs)."""
    rows = encode_rows(points, lanes, curve, device)
    sc = torch.zeros((rows.shape[0], NLIMBS), dtype=torch.int64,
                     device=device)
    sc[:len(scalars)] = ints_to_tensor([s % FR_MOD for s in scalars], device)
    return rows, sc


def msm(points, scalars, curve: str = "g1", device="cpu", lanes=None):
    """MSM of host affine points (no infinities) and int scalars."""
    if not points:
        return None
    lanes = lanes or msm_lanes(len(points), curve)
    rows, sc = encode_inputs(points, scalars, lanes, curve, device)
    return combine_window_points(
        msm_rows_async(rows, sc, lanes, curve).cpu(), curve)
