"""Sparse R1CS row evaluation over BN254 Fr: a CUDA kernel on a card,
plain PyTorch elsewhere.

Counterpart of `infimum_tpu/groth16/rowval.py`: a|_H, b|_H and c|_H as one
sparse matrix-vector product per matrix.

`SparseRows` keeps, on its device, compressed rows of every matrix in
turn: a row pointer (nmat x num_rows + 1 int32), the terms' columns
(int32) and coefficients (8 int32 words each, c R^2 mod r), sorted by
matrix and row (a zkey's triples come in any order; repeats stay separate
terms, summed like any other); and, on the host, the coefficients in
standard form. `rows_words` evaluates them against the witness's
standard-form words: mont_mul(c R^2, w) = c w R, the same reduced
Montgomery value as mont_mul(c R, w R), so no launch encodes the witness
a prove:

  - on a card, `csrc/fr_rows.cu`: a merge-path walk over the terms and
    row ends of every output row, each thread a fixed slice of
    ROW_ITEMS of them whatever the rows' lengths (`row_partition` finds
    the slices once per domain, on the host, and keeps them on the
    rows' device), each row summed in Fr adds;
  - on the CPU, `rows_plain`: per term mont_mul(coeff, w[col]) of the
    standard-form coefficient and witness value (c w R^-1), in chunks of
    terms (the process circuit has about 3.9M), `index_add_` by row (the
    values are linear, so limb sums accumulate exactly in int64), then
    one carry pass, a fold of the carry-out, conditional subtractions and
    one product by R^3 (the R^-1 and the encoding's R back): reduced
    Montgomery rows, the NTT's input encoding. It reads the standard-form
    coefficients, not the R^2 table the card's encoding wrote, so a fault
    in that encoding shows as a difference.

Both give each row's reduced value, so the two agree limb for limb.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..ff.bn254 import FR_MOD
from ..ff.fp import (
    FR_CTX, NLIMBS, carry, device_key, limbs_to_words, sub_borrow,
    words_to_limbs,
)
from ..ntt.ntt import (
    WORDS, _on_cuda, _words_check, fr_const, pointwise,
)

P = FR_MOD
TERM_CHUNK = 1 << 18
ROW_ITEMS = 8          # csrc/fr_rows.cu kRowItems: items (terms, row ends) a thread
WARP = 32


def ints_to_words(xs, device) -> torch.Tensor:
    """python ints -> (N, 8) int32 words of each x mod r on `device`: the
    one host conversion of a witness or a coefficient list (one bytes
    buffer, no per-limb work)."""
    buf = bytearray(b"".join([(x % P).to_bytes(32, "little") for x in xs]))
    return torch.frombuffer(buf, dtype=torch.int32).reshape(
        -1, WORDS).to(device) if buf else torch.zeros(
        (0, WORDS), dtype=torch.int32, device=device)


def to_r2_words(std: torch.Tensor) -> torch.Tensor:
    """Standard-form words c -> c R^2 mod r, the row table's form: one
    pointwise launch, a Montgomery product by R^3 mod r, on a card; its
    plain version on the CPU."""
    return pointwise(std, k=fr_const(FR_CTX.R2 * FR_CTX.R,
                                     device_key(std.device), mont=False))


def flatten_rows(rows) -> dict:
    """{"A" | "B" | "C": (coeffs, cols, rows)} lists of the terms of R1CS
    rows given as (a, b, c) triples of LCs."""
    mats = {}
    for name, idx in (("A", 0), ("B", 1), ("C", 2)):
        coeffs, cols, rids = [], [], []
        for j, triple in enumerate(rows):
            terms = triple[idx].terms
            coeffs.extend(terms.values())
            cols.extend(terms.keys())
            rids.extend([j] * len(terms))
        mats[name] = (coeffs, cols, rids)
    return mats


def row_ends(rowptr: np.ndarray, num_rows: int, nmat: int,
             m: int) -> np.ndarray:
    """(nmat x m,) int64 end of each output row's terms, row g = matrix x m
    + row: the row pointer's, and for the domain's padding rows
    num_rows..m-1 (no term) the end of their matrix's terms."""
    idx = (np.arange(nmat)[:, None] * num_rows
           + np.minimum(np.arange(1, m + 1), num_rows)[None, :])
    return np.asarray(rowptr, dtype=np.int64)[idx.reshape(-1)]


def row_partition(ends: np.ndarray):
    """Merge-path split of the items of rows with these ends: each row's
    terms, then its end, in row order, ROW_ITEMS a thread, 32 threads a
    warp, whatever the rows' lengths.

    Returns (slices, cross): `slices` ((nwarps x 32 + 1, 2) int64) holds
    the rows ended and the terms before each thread's items (thread s
    ends rows slices[s, 0] .. slices[s + 1, 0] - 1, one writer each, and
    takes terms slices[s, 1] .. slices[s + 1, 1] - 1); `cross` ((ncross,
    3) int64) lists each row that continues past a warp's end with the
    warps that end inside it (row, first warp, end warp): their carries
    go into that row."""
    nrows = ends.shape[0]
    nnz = int(ends[-1]) if nrows else 0
    total = nrows + nnz
    nwarps = -(-total // (WARP * ROW_ITEMS))
    diag = np.minimum(np.arange(nwarps * WARP + 1, dtype=np.int64)
                      * ROW_ITEMS, total)
    # row g's end is item ends[g] + g; before diagonal d lie the ends
    # below it and d minus their count terms
    done = np.searchsorted(ends + np.arange(nrows), diag, side="left")
    slices = np.stack([done, diag - done], axis=1)
    row, term = slices[WARP::WARP].T           # at each warp's end
    start = np.concatenate([[0], ends])[np.minimum(row, nrows)]
    inside = np.flatnonzero((row < nrows) & (start < term))
    cross = np.zeros((0, 3), dtype=np.int64)
    if inside.size:
        first = np.flatnonzero(np.diff(row[inside], prepend=-1))
        last = np.append(first[1:], inside.size)
        cross = np.stack([row[inside[first]], inside[first],
                          inside[last - 1] + 1], axis=1)
    return slices, cross


@dataclasses.dataclass
class RowPartition:
    """`row_partition` of one SparseRows at one domain, on its device, as
    `csrc/fr_rows.cu` reads it (int32), with its host arrays."""
    ends: torch.Tensor       # (nmat x m,) row ends
    slices: torch.Tensor     # (nwarps x 32 + 1, 2) rows ended, terms
    cross: torch.Tensor      # (ncross, 3) row, first warp, end warp
    host: tuple              # (ends, slices, cross) as numpy int64

    @property
    def nwarps(self) -> int:
        return (self.slices.shape[0] - 1) // WARP

    @property
    def ncross(self) -> int:
        return self.cross.shape[0]


class SparseRows:
    """Compressed rows of sparse matrices on one device, each coefficient
    c as c R^2 mod r (encoded once, when the rows are built). `mats` maps
    each matrix's name to its (coeffs, cols, rows) lists: `flatten_rows`
    of an R1CS, or a snarkjs .zkey's A and B triples (any order, repeats
    summed). Each matrix has `num_rows` rows;
    a row of 2^16 terms or more is refused, as the reference refuses it
    (its limb sums would overflow)."""

    def __init__(self, mats: dict, num_rows: int, device="cpu"):
        self.num_rows = num_rows
        self.device = device
        self.names = tuple(mats)
        counts, cols, coeffs = [], [], []
        self.longest = 0
        for coeff, col, rid in mats.values():
            rid = np.asarray(rid, dtype=np.int64)
            if rid.size and (rid.min() < 0 or rid.max() >= num_rows):
                raise ValueError(f"row index outside [0, {num_rows})")
            count = np.bincount(rid, minlength=num_rows)
            if rid.size and count.max() >= 1 << 16:
                raise ValueError("row too long for one-limb carry fold")
            self.longest = max(self.longest, int(count.max(initial=0)))
            order = np.argsort(rid, kind="stable")
            counts.append(count)
            cols.append(np.asarray(col, dtype=np.int64)[order])
            coeffs.append(np.asarray(coeff, dtype=object)[order])
        rowptr = np.concatenate([[0], np.cumsum(np.concatenate(
            counts or [np.zeros(0, np.int64)]))])
        if rowptr[-1] >= 1 << 31:
            raise ValueError("more than 2^31 terms")
        col = np.concatenate(cols or [np.zeros(0, np.int64)])
        self.nnz = int(rowptr[-1])
        self.max_col = int(col.max(initial=-1))
        self.rowptr_host = rowptr
        self.rowptr = torch.from_numpy(rowptr.astype(np.int32)).to(device)
        self.cols = torch.from_numpy(col.astype(np.int32)).to(device)
        self.coeffs_std = ints_to_words(
            np.concatenate(coeffs or [[]]).tolist(), "cpu")
        self.coeffs = torch.cat([
            to_r2_words(self.coeffs_std[i:i + TERM_CHUNK].to(device))
            for i in range(0, self.nnz, TERM_CHUNK)]) if self.nnz else \
            self.coeffs_std.to(device)

    @property
    def nmat(self) -> int:
        return len(self.names)

    def partition(self, m: int) -> RowPartition:
        """The row kernel's slices at domain m, built once per domain."""
        cache = self.__dict__.setdefault("_partitions", {})
        if m not in cache:
            ends = row_ends(self.rowptr_host, self.num_rows, self.nmat, m)
            if ends.shape[0] + self.nnz >= 1 << 31:
                raise ValueError("more than 2^31 rows and terms")
            host = (ends, *row_partition(ends))
            cache[m] = RowPartition(*(
                torch.from_numpy(a.astype(np.int32)).to(self.device)
                for a in host), host)
        return cache[m]


def _shift_mont(device):
    """2^256 mod P in Montgomery form: mont_mul(c, this) = c * 2^256 mod P."""
    return FR_CTX.encode([(1 << 256) % P], device)[0]


def _reduce_rows(sums: torch.Tensor) -> torch.Tensor:
    """(m, 16) int64 limb sums (rows of < 2^16 terms) -> reduced mod P."""
    limbs, c = carry(sums.T)               # value = limbs + c * 2^256
    fold = FR_CTX.mont_mul(
        torch.nn.functional.pad(c.unsqueeze(-1), (0, NLIMBS - 1)),
        _shift_mont(sums.device))          # c < 2^16: one limb
    n = FR_CTX.consts(sums.device)[0].unsqueeze(-1)
    for _ in range(5):                     # limbs < 2^256 < 6P
        d, borrow = sub_borrow(limbs, n)
        limbs = torch.where(borrow == 0, d, limbs)
    return FR_CTX.add(limbs.T, fold)


def rows_plain(sp: SparseRows, w_std: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version of the row launch, on the same rows, the standard-
    form coefficients and the standard-form witness words: (nmat, m, 8)
    reduced Montgomery words, rows num_rows..m-1 zero."""
    dev, nr = w_std.device, max(sp.num_rows, 1)
    rid = torch.repeat_interleave(
        torch.arange(sp.nmat * sp.num_rows, device=dev),
        (sp.rowptr[1:] - sp.rowptr[:-1]).to(torch.int64))
    out_row = rid // nr * m + rid % nr
    cols = sp.cols.to(torch.int64)
    w = words_to_limbs(w_std)
    sums = torch.zeros((sp.nmat * m, NLIMBS), dtype=torch.int64, device=dev)
    for i in range(0, rid.shape[0], TERM_CHUNK):
        j = i + TERM_CHUNK
        sums.index_add_(0, out_row[i:j], FR_CTX.mont_mul(
            words_to_limbs(sp.coeffs_std[i:j].to(dev)), w[cols[i:j]]))
    r3 = words_to_limbs(fr_const(FR_CTX.R2 * FR_CTX.R, device_key(dev),
                                 mont=False))
    return limbs_to_words(FR_CTX.mont_mul(_reduce_rows(sums), r3)).reshape(
        sp.nmat, m, WORDS)


def rows_words(sp: SparseRows, w_std: torch.Tensor, m: int) -> torch.Tensor:
    """(nmat, m, 8) reduced Montgomery words of every matrix of `sp`
    against the witness's standard-form words `w_std`: the row launch on
    a card, `rows_plain` on the CPU."""
    if m < sp.num_rows:
        raise ValueError(f"domain {m} below {sp.num_rows} rows")
    if sp.max_col >= w_std.shape[0]:
        raise ValueError(f"column {sp.max_col} outside a witness of "
                         f"{w_std.shape[0]}")
    if not _on_cuda(w_std, sp.rowptr):
        return rows_plain(sp, w_std, m)
    _words_check("w_std", w_std)
    part = sp.partition(m)
    out = torch.empty((sp.nmat, m, WORDS), dtype=torch.int32,
                      device=w_std.device)
    carry = torch.empty((part.nwarps, WORDS), dtype=torch.int32,
                        device=w_std.device)
    kernels.KERNELS["fr_rows"](part.ends, part.slices, part.cross, sp.cols,
                               sp.coeffs, w_std, carry, out, part.nwarps,
                               part.ncross)
    return out

