"""Signed-digit Pippenger MSM for BN254 G1 and G2, on CUDA kernels.

Counterpart of `infimum_tpu/msm/pallas_msm.py:403-553`. Per window, with
all windows batched into each launch:

  1. kernels `msm_recode`, `msm_scatter` (csrc/msm_layout.cu,
     `lane_layout`): in one launch from the scalars' standard-form words,
     their signed c-bit recode with per-block |digit| histograms and
     their offsets (padding rows and the query's infinity points recode
     as zero digits, unread); then a stable counting sort of each window
     by |digit| with the signs and the entries' rows; lane l owns the
     sorted range [l*T, (l+1)*T). No copy of the points or the scalars is
     made.
  2. kernel `msm_accum` (csrc/msm_accum.cu): run-emission accumulation.
     It reads each entry's affine point from the row-major (N, AW) table
     through the sort's order. Its emissions are the reference's: (nwin,
     T+1, L) digits and (nwin, T+1, PW, L) points, lane l's runs in order.
  3. kernel `msm_compact` (csrc/msm_layout.cu, `compact`): the sorted order
     bounds the live emissions per window by n_buckets + L + 2, so they
     pack, lane by lane, into that many slots: each window's list is then
     non-decreasing in digit.
  4. kernel `msm_weighted` (csrc/msm_weighted.cu): sum of digit * point
     over each window's emissions, by running sums over chunks of the
     sorted list.

The window sums combine on the host: Horner, c doublings per window, in
the port's native library's Jacobian arithmetic (`native.msm_combine`, one
inversion an MSM).
Inside the pipeline a field element is 8 32-bit words (int32 tensors,
the bit pattern of uint32); at the public functions it is 16 16-bit limbs,
Montgomery R = 2^256 in both, so the values are the same integers.

Each kernel wrapper launches its kernel for a CUDA tensor and raises for
any other device but the CPU; for a CPU tensor it runs the plain version
beside it, which computes the same outputs in torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

from .. import kernels, native
from ..curve.proj import CURVES
from ..ff.bn254 import FR_MOD
from ..ff.fp import NLIMBS, ints_to_tensor, limbs_to_words, words_to_limbs

# lane counts on the card: each (window, lane) thread walks T = N / L
# entries; at the poll's shapes (130k-260k points) T is 36-70
LANES_MAX = {"g1": 4096, "g2": 2048}


class CurveSpec:
    """Static parameters binding the pipeline to G1 or G2. An affine point
    is AF 16-bit limbs or AW 32-bit words, x then y: one row of the table
    the accumulation kernel reads; a projective point (an emission, a
    window sum) is PR limbs or PW words, X, Y, Z."""

    def __init__(self, name: str, c_bits: int, chunk: int, layout_chunk: int,
                 recode_group: int):
        self.name = name
        self.curve = CURVES[name]
        self.c_bits = c_bits
        self.chunk = chunk          # = CHUNK_G1 / CHUNK_G2, msm_weighted.cu
        # entries a block of the layout's histograms and scatter: = kChunkG1
        # / kChunkG2, msm_layout.cu
        self.layout_chunk = layout_chunk
        # windows a recode item counts: = kGroupG1 / kGroupG2, msm_layout.cu
        self.recode_group = recode_group
        self.n_buckets = 1 << (c_bits - 1)
        self.n_windows = -(-254 // c_bits)
        self.RF = NLIMBS * (2 if name == "g2" else 1)  # 16-bit limbs per coord
        self.AF, self.PR = 2 * self.RF, 3 * self.RF
        self.AW, self.PW = self.AF // 2, self.PR // 2


G1_SPEC = CurveSpec("g1", 13, 8, 8192, 4)   # 20 windows
G2_SPEC = CurveSpec("g2", 10, 4, 4096, 4)   # 26 windows
SPECS = {"g1": G1_SPEC, "g2": G2_SPEC}


def msm_lanes(n: int, curve: str) -> int:
    """Power-of-two lane count giving about 32 entries per lane."""
    lanes = 8
    while lanes * 32 < n and lanes < LANES_MAX[curve]:
        lanes *= 2
    return lanes


# -- points as words ----------------------------------------------------------------

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
    r < 2^254, so the top window never carries out. All windows at once,
    by carry lookahead: a window whose raw digit is above 2^(c-1) carries
    out whatever comes in, one below never does, one equal to it passes
    its carry-in on; so a window carries out when the nearest window at or
    below it that is not equal to 2^(c-1) is above it."""
    c, half = spec.c_bits, spec.n_buckets
    w = torch.arange(spec.n_windows, device=sc.device)
    limbs = tnf.pad(sc, (0, 1)).T.contiguous()              # (17, N)
    comb = limbs[(c * w) // 16] | (limbs[(c * w) // 16 + 1] << 16)
    raw = (comb >> ((c * w) % 16)[:, None]) & ((1 << c) - 1)  # (nwin, N)
    last = torch.where(raw != half, w[:, None], -1).cummax(0).values
    cout = (raw > half).gather(0, last.clamp(min=0)) & (last >= 0)
    d = raw + tnf.pad(cout[:-1].to(torch.int64), (0, 0, 1, 0))
    neg = d > half
    return (torch.where(neg, 2 * half - d, d).to(torch.int32),
            neg.to(torch.int32))


def _check(t: torch.Tensor, shape, name: str, dtype=torch.int32):
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


# -- the layout's kernels: recode, offsets, stable scatter --------------------------

SCATTER_WARPS = 8           # = kScatterWarps, msm_layout.cu
SIGN_BIT = 1 << 15          # a packed digit: |digit| | sign << 15 (uint16)


def layout_blocks(n: int, spec: CurveSpec) -> int:
    """Blocks of `spec.layout_chunk` entries a window of n entries."""
    return -(-n // spec.layout_chunk)


def padded_limbs(sc, rows: int, mask=None) -> torch.Tensor:
    """(rows, 16) int64 limbs of a query's scalars: `sc` ((n, 8) words or
    (n, 16) limbs, n <= rows) above zero rows, zero where `mask` (a bool
    of at least n rows: the query's infinity points) is set."""
    n = sc.shape[0]
    limbs = words_to_limbs(sc) if sc.dtype == torch.int32 else sc
    if n == rows and mask is None:
        return limbs
    out = torch.zeros((rows, NLIMBS), dtype=torch.int64, device=sc.device)
    out[:n] = limbs if mask is None else torch.where(
        mask[:n].unsqueeze(-1), 0, limbs)
    return out


def layout_recode(sc, spec: CurveSpec, rows=None, mask=None):
    """A query's scalars, reduced mod r, as (n, 8) int32 standard-form
    words or (n, 16) int64 limbs, for `rows` >= n table rows (default n;
    rows n and above hold zero scalars) with `mask` an optional bool of at
    least n rows (the query's infinity points: their scalars count as
    zero) -> packed (nwin, rows) int16 digits, |digit| | sign << 15 (the
    bit pattern of uint16); offsets (nwin, nblk, bins) int32, each block's
    count of each |digit| in its window (blocks of `spec.layout_chunk`
    rows, bins = 2^(c-1) + 1) scanned exclusively over the blocks; and
    totals (nwin, bins) int32, each bin's count in its window. On the
    card one launch from the words (limbs converted first)."""
    n = sc.shape[0]
    rows = n if rows is None else rows
    nblk = layout_blocks(rows, spec)
    if sc.device.type == "cuda":
        words = as_words(sc, NLIMBS // 2)
        _check(words, (n, NLIMBS // 2), "sc")
        if words.data_ptr() % 16:
            raise ValueError("sc: the kernel reads 16-byte vectors")
        if rows < n or rows % 2:
            raise ValueError(f"{rows} rows: want an even count >= {n}")
        if mask is not None and (mask.dtype != torch.bool or mask.dim() != 1
                                 or not mask.is_contiguous()
                                 or mask.shape[0] < n):
            raise ValueError(f"mask: want a contiguous bool of >= {n} rows")
        packed = torch.empty((spec.n_windows, rows), dtype=torch.int16,
                             device=sc.device)
        offsets = torch.empty((spec.n_windows, nblk, spec.n_buckets + 1),
                              dtype=torch.int32, device=sc.device)
        totals = torch.empty((spec.n_windows, spec.n_buckets + 1),
                             dtype=torch.int32, device=sc.device)
        kernels.KERNELS[f"msm_recode_{spec.name}"](
            words, mask, packed, offsets, totals, n, rows, nblk)
        return packed, offsets, totals
    if sc.device.type != "cpu":
        raise ValueError(f"no msm_recode kernel for {sc.device}")
    packed, counts = layout_recode_plain(sc, spec, rows, mask)
    return packed, counts, layout_scan_plain(counts)


def layout_recode_plain(sc, spec: CurveSpec, rows=None, mask=None):
    """Plain torch version of the recode kernel's first half, on words or
    limbs as `layout_recode` takes them: `recode` of the padded, masked
    limbs, packed, and each (window, block)'s histogram, unscanned."""
    mags, sgns = recode(padded_limbs(sc, rows or sc.shape[0], mask), spec)
    nwin, n = mags.shape
    bins, nblk = spec.n_buckets + 1, layout_blocks(n, spec)
    blk = torch.arange(n, device=sc.device) // spec.layout_chunk
    win = torch.arange(nwin, device=sc.device)[:, None]
    counts = torch.bincount(((win * nblk + blk) * bins + mags).flatten(),
                            minlength=nwin * nblk * bins)
    return ((mags - sgns * SIGN_BIT).to(torch.int16),
            counts.view(nwin, nblk, bins).to(torch.int32))


def layout_scan_plain(counts):
    """Plain torch version of the recode kernel's scan: counts (nwin, nblk,
    bins) int32 -> totals (nwin, bins) int32, each bin's count in its
    window; counts becomes, in place, its exclusive prefix over the
    blocks: each block's first slot in each bin, counted from the bin's
    first slot."""
    totals = counts.sum(1, dtype=torch.int32)
    counts.copy_(counts.cumsum(1) - counts)
    return totals


def layout_scatter(packed, offsets, totals, spec: CurveSpec):
    """packed (nwin, N) int16 digits, offsets (nwin, nblk, bins) the scanned
    counts and totals (nwin, bins) -> sdig, ssgn, order (nwin, N) int32:
    each window's |digits| in stable sorted order, their signs and the
    index of each entry."""
    nwin, n = packed.shape
    nblk, bins = layout_blocks(n, spec), spec.n_buckets + 1
    if packed.device.type == "cuda":
        _check(packed, (nwin, n), "packed", torch.int16)
        _check(offsets, (nwin, nblk, bins), "offsets")
        _check(totals, (nwin, bins), "totals")
        out = torch.empty((3, nwin, n), dtype=torch.int32,
                          device=packed.device)
        kernels.KERNELS[f"msm_scatter_{spec.name}"](
            packed, offsets, totals, out[0], out[1], out[2], n, nblk)
        return out.unbind(0)
    if packed.device.type != "cpu":
        raise ValueError(f"no msm_scatter kernel for {packed.device}")
    return layout_scatter_plain(packed, offsets, totals, spec)


def layout_scatter_plain(packed, offsets, totals, spec: CurveSpec):
    """Plain torch version of the scatter kernel's index arithmetic: an
    entry's slot is its bin's first slot in the window (the exclusive scan
    of the totals over the bins), plus its block's offset in the bin, plus
    its rank among the equal digits before it in its block; the digit of
    sorted position s is the bin whose slots hold s."""
    nwin, n = packed.shape
    dev = packed.device
    mags = (packed & 0x7FFF).to(torch.int64)
    ends = totals.to(torch.int64).cumsum(1)
    blk = torch.arange(n, device=dev) // spec.layout_chunk
    win = torch.arange(nwin, device=dev)[:, None]
    first = (ends - totals).gather(1, mags) + offsets[win, blk, mags]
    key, perm = torch.sort(blk * (spec.n_buckets + 1) + mags, dim=1,
                           stable=True)
    pos = torch.arange(n, device=dev).expand(nwin, n)
    new = torch.ones_like(key, dtype=torch.bool)
    new[:, 1:] = key[:, 1:] != key[:, :-1]
    start = torch.where(new, pos, 0).cummax(1).values
    dest = first + torch.empty_like(perm).scatter_(1, perm, pos - start)
    ssgn = torch.empty((nwin, n), dtype=torch.int32, device=dev)
    ssgn.scatter_(1, dest, (packed < 0).to(torch.int32))
    order = torch.empty((nwin, n), dtype=torch.int32, device=dev)
    order.scatter_(1, dest, pos.to(torch.int32))
    sdig = torch.searchsorted(ends, pos.contiguous(), right=True)
    return sdig.to(torch.int32), ssgn, order


# -- kernel 1: run-emission accumulation --------------------------------------------


def accumulate(sdig, ssgn, order, words, spec: CurveSpec):
    """sdig, ssgn, order (nwin, L, T) int32: each window's |digit|-sorted
    digits, their signs and the table row of each, lane l owning sorted
    entries [l*T, (l+1)*T); words (L*T, AW) int32: the affine points ->
    edig (nwin, T+1, L) int32, ept (nwin, T+1, PW, L) int32 words.

    Emission t < T is the run that ended before entry t (digit 0: none or
    dead); emission T is each lane's final run. Dead emissions' points are
    unspecified."""
    if words.device.type == "cuda":
        nwin, L, T = sdig.shape
        for t, name in ((sdig, "sdig"), (ssgn, "ssgn"), (order, "order")):
            _check(t, (nwin, L, T), name)
        _check(words, (L * T, spec.AW), "words")
        if words.data_ptr() % 16:
            raise ValueError("words: the kernel reads 16-byte vectors")
        edig = torch.empty((nwin, T + 1, L), dtype=torch.int32,
                           device=words.device)
        ept = torch.empty((nwin, T + 1, spec.PW, L), dtype=torch.int32,
                          device=words.device)
        kernels.KERNELS[f"msm_accum_{spec.name}"](
            sdig, ssgn, order, words, edig, ept, nwin, T, L)
        return edig, ept
    if words.device.type != "cpu":
        raise ValueError(f"no msm_accum kernel for {words.device}")
    return accumulate_plain(sdig, ssgn, order, words, spec)


def accumulate_plain(sdig, ssgn, order, words, spec: CurveSpec):
    """Plain torch version of the accumulation kernel, the same gather:
    each entry's point is the table row its order names."""
    curve, F = spec.curve, spec.curve.F
    nwin, L, T = sdig.shape
    dev = words.device
    rows = words[order.to(torch.int64)].transpose(1, 2)  # (nwin, T, L, AW)
    pts = _words_point(rows, spec, 2)                     # (nwin, T, L, field)
    acc = curve.infinity((nwin, L), dev)
    one = curve.one((nwin, L), dev)
    ad = torch.zeros((nwin, L), dtype=torch.int64, device=dev)
    edig, ept = [], []
    for t in range(T):
        d = sdig[:, :, t].to(torch.int64)
        px, py = pts[0][:, t], pts[1][:, t]
        py = F.select(ssgn[:, :, t] != 0, F.neg(py), py)
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
    (nwin, K) int32 digits and (nwin, PW, K) int32 words, zero-padded.

    The emissions are taken lane by lane: lane l holds the sorted range
    [l*T, (l+1)*T) and emits its runs in rising digit order, so each
    window's packed digits are non-decreasing."""
    nwin, T1, PW, L = ept.shape
    if ept.device.type == "cuda":
        curve = {spec.PW: name for name, spec in SPECS.items()}.get(PW)
        if curve is None:
            raise ValueError(f"no msm_compact kernel for {PW} words")
        _check(edig, (nwin, T1, L), "edig")
        _check(ept, (nwin, T1, PW, L), "ept")
        # the lane counts, then the slot list: each live slot's source
        # t * L + l, -1 above the live ones
        scratch = torch.empty(nwin * (L + K), dtype=torch.int32,
                              device=ept.device)
        cdig = torch.empty((nwin, K), dtype=torch.int32, device=ept.device)
        cpts = torch.empty((nwin, PW, K), dtype=torch.int32, device=ept.device)
        kernels.KERNELS[f"msm_compact_{curve}"](edig, ept, scratch, cdig,
                                                cpts, nwin, T1, L, K)
        return cdig, cpts
    if ept.device.type != "cpu":
        raise ValueError(f"no msm_compact kernel for {ept.device}")
    return compact_plain(edig, ept, K)


def compact_plain(edig, ept, K: int):
    """Plain torch version of the compaction kernel: flags, a running count
    and a scatter, each dead emission to slot K (dropped)."""
    nwin, T1, PW, L = ept.shape
    flat = edig.transpose(1, 2).reshape(nwin, L * T1)
    flags = flat > 0
    dest = torch.where(flags, flags.cumsum(1) - 1, K)   # slot K: dropped
    cdig = torch.zeros((nwin, K + 1), dtype=torch.int32, device=edig.device)
    cdig.scatter_(1, dest, flat)
    rows = ept.permute(0, 2, 3, 1).reshape(nwin, PW, L * T1)
    cpts = torch.zeros((nwin, PW, K + 1), dtype=torch.int32,
                       device=edig.device)
    cpts.scatter_(2, dest.unsqueeze(1).expand(-1, PW, -1), rows)
    return cdig[:, :K].contiguous(), cpts[:, :, :K].contiguous()


# -- kernel 2: weighted bucket reduction ----------------------------------------------

CHUNKS_PER_BLOCK = 32       # one warp: a thread per chunk


def weighted_blocks(K: int, spec: CurveSpec) -> int:
    """Blocks per window of the weighted kernel's first launch."""
    return -(-K // (CHUNKS_PER_BLOCK * spec.chunk))


def weighted_sum(cdig, cpts, spec: CurveSpec):
    """cdig (nwin, K) int32, non-decreasing live digits then zeros; cpts
    (nwin, PW, K) int32 words -> (nwin, PW) int32 words: per window the
    projective sum of digit * point."""
    if cpts.device.type == "cuda":
        nwin, K = cdig.shape
        _check(cdig, (nwin, K), "cdig")
        _check(cpts, (nwin, spec.PW, K), "cpts")
        partial = torch.empty((nwin, weighted_blocks(K, spec), spec.PW),
                              dtype=torch.int32, device=cpts.device)
        out = torch.empty((nwin, spec.PW), dtype=torch.int32,
                          device=cpts.device)
        kernels.KERNELS[f"msm_weighted_{spec.name}"](
            cdig, cpts, partial, out, nwin, K)
        return out
    if cpts.device.type != "cpu":
        raise ValueError(f"no msm_weighted kernel for {cpts.device}")
    return weighted_sum_plain(cdig, cpts, spec)


def _chunk_digits(cdig, chunk: int):
    """The live prefix of each window's digits cut into chunks of `chunk`
    slots: (nwin, nc, chunk) int64, zero-padded; None when no slot is
    live."""
    nwin, K = cdig.shape
    live = int((cdig != 0).sum(1).max())
    if live == 0:
        return None
    n = -(-live // chunk) * chunk
    d = tnf.pad(cdig[:, :n], (0, n - min(n, K)))
    return d.reshape(nwin, -1, chunk).to(torch.int64)


def _chunk_points(cpts, spec: CurveSpec, nc: int, chunk: int):
    """The points of the first nc chunks: a tuple of 3 (nwin, nc, chunk,
    field shape)."""
    nwin, _, K = cpts.shape
    n = nc * chunk
    words = tnf.pad(cpts[:, :, :n], (0, n - min(n, K)))
    words = words.reshape(nwin, spec.PW, nc, chunk).permute(0, 2, 3, 1)
    return _words_point(words, spec, 3)


def _add_multiple(curve, a, s, g):
    """a + g * s elementwise for int64 g >= 0, by double-and-add."""
    nb = int(g.max()).bit_length()
    if nb == 0:
        return a
    inf = curve.infinity(g.shape, g.device)
    t = curve.select(((g >> (nb - 1)) & 1) == 1, s, inf)
    for b in range(nb - 2, -1, -1):
        t = curve.add(t, t)
        t = curve.select(((g >> b) & 1) == 1, curve.add(t, s), t)
    return curve.add(a, t)


def weighted_sum_plain(cdig, cpts, spec: CurveSpec):
    """Plain torch version of the weighted kernel, the same algorithm: each
    chunk of `spec.chunk` slots walked from its top entry down with a running
    sum (S += P_e, A += (d_above - d_e) * S, then A += d_first * S), then
    a halving tree over the chunk values. Compaction puts the live entries
    first, so only the chunks of the longest live prefix are computed."""
    chunk = spec.chunk
    curve = spec.curve
    nwin = cdig.shape[0]
    dev = cdig.device
    d = _chunk_digits(cdig, chunk)
    if d is None:
        return _point_words(curve.infinity((nwin,), dev), spec)
    nc = d.shape[1]
    pts = _chunk_points(cpts, spec, nc, chunk)
    acc = curve.infinity((nwin, nc), dev)
    s = curve.infinity((nwin, nc), dev)
    above = torch.zeros((nwin, nc), dtype=torch.int64, device=dev)
    for j in range(chunk - 1, -1, -1):
        dj = d[..., j]
        lv = dj > 0
        if not bool(lv.any()):
            continue
        acc = _add_multiple(curve, acc, s,
                            torch.where(lv & (above > 0), above - dj, 0))
        s = curve.select(lv, curve.add(s, tuple(c[:, :, j] for c in pts)), s)
        above = torch.where(lv, dj, above)
    part = _add_multiple(curve, acc, s, above)
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

def as_words(t, width: int):
    """The (N, width) int32 words of a tensor given as words (returned as
    it is) or as (N, 2 width) int64 limbs (converted)."""
    if t.dtype == torch.int32:
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"want (N, {width}) words, got "
                             f"{tuple(t.shape)}")
        return t
    return limbs_to_words(t)


def table_words(rows, spec: CurveSpec):
    """The (N, AW) words of a table of affine points (`as_words`)."""
    return as_words(rows, spec.AW)


def lane_layout(rows, sc, lanes: int, spec: CurveSpec, mask=None):
    """Recode and sort each window by |digit|: the accumulation kernel's
    inputs (sdig, ssgn, order, words) for rows (N, AF) limbs or (N, AW)
    words, N = T * lanes, and scalars (n, 8) words or (n, 16) limbs, n <=
    N, with the query's infinity mask `mask` (see `layout_recode`). sdig,
    ssgn and order are (nwin, L, T) views of the stable sort's (nwin, N)
    results, lane l owning sorted entries [l*T, (l+1)*T); words is the
    (N, AW) table of the points, which the kernel reads through order. On
    the card: the recode and scatter kernels, and words as given."""
    N = rows.shape[0]
    if N % lanes or sc.shape[0] > N:
        raise ValueError(f"{N} rows do not fill {lanes} lanes or hold "
                         f"{sc.shape[0]} scalars")
    if sc.device.type == "cuda":
        shape = (spec.n_windows, lanes, N // lanes)
        packed, offsets, totals = layout_recode(sc, spec, N, mask)
        sdig, ssgn, order = layout_scatter(packed, offsets, totals, spec)
        return (sdig.view(shape), ssgn.view(shape), order.view(shape),
                table_words(rows, spec))
    if sc.device.type != "cpu":
        raise ValueError(f"no msm layout kernels for {sc.device}")
    return lane_layout_plain(rows, sc, lanes, spec, mask)


def lane_layout_plain(rows, sc, lanes: int, spec: CurveSpec, mask=None):
    """Plain torch version of the layout kernels: `recode` of the padded,
    masked scalars, a stable sort of each window and the gather of the
    signs."""
    N = rows.shape[0]
    shape = (spec.n_windows, lanes, N // lanes)
    mags, sgns = recode(padded_limbs(sc, N, mask), spec)
    sdig, order = torch.sort(mags, dim=1, stable=True)
    ssgn = sgns.gather(1, order)
    return (sdig.view(shape), ssgn.view(shape),
            order.to(torch.int32).view(shape), table_words(rows, spec))


def msm_rows_words(rows, sc, lanes: int, curve: str = "g1",
                   mask=None) -> torch.Tensor:
    """rows (N, AF) affine Montgomery limbs or their (N, AW) words, sc
    (n, 16) standard-form scalar limbs or their (n, 8) words, reduced mod
    r, n <= N = T * lanes (rows from n on, and those `mask` sets, take
    zero scalars) -> (nwin, PW) window-sum words.

    Dispatches the whole pipeline without a host wait on the card."""
    spec = SPECS[curve]
    edig, ept = accumulate(*lane_layout(rows, sc, lanes, spec, mask), spec)
    cdig, cpts = compact(edig, ept, spec.n_buckets + lanes + 2)
    return weighted_sum(cdig, cpts, spec)


def msm_rows_async(rows, sc, lanes: int, curve: str = "g1",
                   mask=None) -> torch.Tensor:
    """`msm_rows_words` as (nwin, PR) window-sum limbs."""
    return words_to_limbs(msm_rows_words(rows, sc, lanes, curve, mask))


def decode_windows(wins, curve: str = "g1"):
    """(nwin, PR) window-sum limbs -> host affine points / None."""
    spec = SPECS[curve]
    w = torch.as_tensor(wins).reshape(-1, 3, *spec.curve.fshape())
    return spec.curve.decode((w[:, 0], w[:, 1], w[:, 2]))


def combine_window_points(wins, curve: str = "g1"):
    """(nwin, PR) window-sum limbs or their (nwin, PW) words (least
    significant first) -> one host affine point / None: Horner in the
    native library's Jacobian arithmetic."""
    spec = SPECS[curve]
    w = torch.as_tensor(wins).cpu()
    words = w if w.dtype == torch.int32 else limbs_to_words(w)
    return native.msm_combine(words.reshape(-1, spec.PW).numpy(), curve,
                              spec.c_bits)


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


def msm(points, scalars, curve: str = "g1", device="cuda", lanes=None):
    """MSM of host affine points (no infinities) and int scalars."""
    if not points:
        return None
    lanes = lanes or msm_lanes(len(points), curve)
    rows, sc = encode_inputs(points, scalars, lanes, curve, device)
    return combine_window_points(
        msm_rows_async(rows, sc, lanes, curve).cpu(), curve)
