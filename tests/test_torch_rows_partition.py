"""The merge-path split of the row kernel (csrc/fr_rows.cu) and the shared
memory layout of the NTT tile kernel (csrc/fr_ntt.cu), on the CPU.

The kernels run only on a card. What surrounds them runs here:
`rowval.row_partition` builds the slices the row kernel walks, so these
tests hold its invariants on three kinds of matrices (a mix of row lengths
like the process circuit's, a row longer than four warps' slices, and
shuffled zkey triples with repeats, empty rows and the domain's padding);
`rows_words` on the CPU is held against the JAX package's
`eval_rows_device` and the zkey path's `_ab_rows_device` on the same
matrices. The tile kernel's swizzle and the pass kernel's, read from the
source, are checked to give every exchange 32 distinct banks a warp, the
pass's at every number of stages and columns a block. Inputs come
from numpy seeds; comparisons are exact (tolerance 0). The kernels
themselves are held against their plain versions on a card
(tests/test_torch_h_kernels.py, marked `cuda`)."""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.groth16 import zkey as ref_zkey
from infimum_tpu.groth16.r1cs import LC
from infimum_tpu.groth16.rowval import SparseRows as RefRows, eval_rows_device
from infimum_tpu_torch.ff.fp import limbs_to_words, to_tensor
from infimum_tpu_torch.groth16 import rowval

torch.set_num_threads(1)  # the suite runs in parallel worker processes

P = FR_MOD
CSRC = pathlib.Path(rowval.__file__).parents[1] / "csrc"
ITEMS = rowval.ROW_ITEMS
WARP_ITEMS = 32 * ITEMS


def _full_width(rng, n):
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]


def _r1cs_mats(lens_per_mat, nv, rng):
    """LC triples whose rows have the given numbers of terms (distinct
    columns), full-width coefficients."""
    rows = []
    for j in range(len(lens_per_mat[0])):
        triple = []
        for lens in lens_per_mat:
            cols = rng.choice(nv, size=int(lens[j]), replace=False)
            triple.append(LC(dict(zip(cols.tolist(),
                                      _full_width(rng, len(cols))))))
        rows.append(tuple(triple))
    return rows


def _matrices(kind):
    """(SparseRows mats, num_rows, m, nv, reference rows or zkey triples)
    of one kind of input, from a numpy seed."""
    rng = np.random.default_rng({"process_mix": 1, "long_row": 2,
                                 "zkey_empty_padding": 3}[kind])
    if kind == "zkey_empty_padding":
        m, nv, nterms = 64, 50, 400
        rows_used = rng.integers(0, m - 20, nterms)   # rows m-20.. empty
        out = [(int(a), int(r), int(s), v) for a, r, s, v in zip(
            rng.integers(0, 2, nterms), rows_used,
            rng.integers(0, nv, nterms), _full_width(rng, nterms))]
        out += out[:nterms // 4]                       # repeats, summed
        triples = [out[i] for i in rng.permutation(len(out))]
        mats = {"A": ([], [], []), "B": ([], [], [])}
        for mat, row, sig, val in triples:
            for lst, x in zip(mats["AB"[mat]], (val, sig, row)):
                lst.append(x)
        return mats, m, m, nv, triples
    if kind == "process_mix":
        num_rows, m, nv = 300, 512, 600
        lens = [rng.choice([0, 1, 2, 67, 275, 507], size=num_rows,
                           p=[0.08, 0.5, 0.3, 0.07, 0.03, 0.02])
                for _ in range(3)]
    else:                          # one row over at least four warps
        num_rows, m, nv = 40, 64, 1500
        lens = [rng.choice([0, 1, 3], size=num_rows) for _ in range(3)]
        lens[1][17] = 4 * WARP_ITEMS + 123
    rows = _r1cs_mats(lens, nv, rng)
    return rowval.flatten_rows(rows), num_rows, m, nv, rows


KINDS = ["process_mix", "long_row", "zkey_empty_padding"]


@pytest.mark.parametrize("kind", KINDS)
def test_row_partition_invariants(kind):
    """Every term lies in exactly one thread's slice, every output row
    (empty and padding rows too) is ended by exactly one thread, no
    thread takes more than ROW_ITEMS items whatever the longest row, and
    the rows listed as crossing a warp's end are exactly the rows whose
    items span two warps, each with the warps that end inside it."""
    mats, num_rows, m, _, _ = _matrices(kind)
    sp = rowval.SparseRows(mats, num_rows, "cpu")
    if kind == "long_row":
        assert sp.longest >= 4 * WARP_ITEMS
    part = sp.partition(m)
    ends, slices, cross = part.host
    nrows, nnz = sp.nmat * m, sp.nnz
    assert ends.shape == (nrows,) and ends[-1] == nnz
    assert np.all(np.diff(ends) >= 0)
    assert slices.shape == (part.nwarps * 32 + 1, 2)
    assert tuple(slices[0]) == (0, 0) and tuple(slices[-1]) == (nrows, nnz)
    step = np.diff(slices, axis=0)
    assert np.all(step >= 0) and np.all(step.sum(1) <= ITEMS)
    assert np.all(step[:(nrows + nnz) // ITEMS].sum(1) == ITEMS)
    # the thread that ends row g holds its end item (ends[g] + g)
    ender = np.repeat(np.arange(len(step)), step[:, 0])
    assert ender.shape == (nrows,)
    assert np.all(slices[ender].sum(1) <= ends + np.arange(nrows))
    assert np.all(ends + np.arange(nrows) < slices[ender + 1].sum(1))
    # every term in one slice, in order
    owner = np.repeat(np.arange(len(step)), step[:, 1])
    assert owner.shape == (nnz,) and np.all(np.diff(owner) >= 0)
    # the rows crossing a warp's end, by brute force over the items
    starts = np.concatenate([[0], ends[:-1]])
    want = []
    for g in np.flatnonzero(ends > starts):
        warps = [w for w in range(part.nwarps)
                 if starts[g] + g < WARP_ITEMS * (w + 1) <= ends[g] + g]
        if warps:
            want.append((g, warps[0], warps[-1] + 1))
            assert warps == list(range(warps[0], warps[-1] + 1))
    assert [tuple(c) for c in cross.tolist()] == want
    assert part.ncross == len(want)
    if kind == "long_row":
        assert max(b - a for _, a, b in want) >= 4
    for t, host in ((part.ends, ends), (part.slices, slices),
                    (part.cross, cross)):
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert np.array_equal(t.numpy(), host)
    assert sp.partition(m) is part              # built once per domain


@pytest.mark.parametrize("kind", KINDS)
def test_rows_words_match_reference_on_synthetic_matrices(kind):
    """`rows_words` on the CPU equals the JAX package's row evaluation on
    the same matrices: `eval_rows_device` for R1CS rows, the zkey path's
    `_ab_rows_device` for shuffled triples (tolerance 0)."""
    mats, num_rows, m, nv, ref = _matrices(kind)
    sp = rowval.SparseRows(mats, num_rows, "cpu")
    w = _full_width(np.random.default_rng(5), nv)
    got = rowval.rows_words(sp, rowval.ints_to_words(w, "cpu"), m)
    if kind == "zkey_empty_padding":
        want = ref_zkey._ab_rows_device(
            types.SimpleNamespace(coeffs=ref, domain_size=m), w)
    else:
        want = eval_rows_device(RefRows(ref, num_rows), w, m)
    assert got.shape == (sp.nmat, m, 8)
    for g, r in zip(got, want):
        assert torch.equal(g, limbs_to_words(to_tensor(np.asarray(r), "cpu")))


def test_row_items_match_kernel_source():
    src = (CSRC / "fr_rows.cu").read_text()
    assert int(re.search(r"constexpr int kRowItems = (\d+);", src).group(1)) \
        == rowval.ROW_ITEMS


# -- the NTT tile kernel's layout and passes -------------------------------------

def _swizzle():
    src = (CSRC / "fr_ntt.cu").read_text()
    body = re.search(r"int swz\(int i\) \{\s*return ([^;]+);", src).group(1)
    assert re.fullmatch(r"[\si()&|^*<>0-9]+", body)
    return eval(f"lambda i: {body}")          # C and Python agree on it


def _exchanges(T):
    """Per pass of the tile kernel, the positions each work item touches:
    the first groups (4 consecutive positions), each radix-4 pass (stages
    st, st + 1) and an odd last stage; 32 consecutive items form a warp."""
    tlog = T.bit_length() - 1
    out = [[[4 * g + c for c in range(4)] for g in range(T // 4)]]
    st = 3
    while st < tlog:
        h = 1 << (st - 1)
        out.append([[((j >> (st - 1)) << (st + 1)) + (j & (h - 1)) + c * h
                     for c in range(4)] for j in range(T // 4)])
        st += 2
    if st == tlog:
        out.append([[k, k + T // 2] for k in range(T // 2)])
    return out


@pytest.mark.parametrize("tlog", [3, 6, 9, 10, 11])
def test_tile_exchanges_hit_distinct_banks(tlog):
    """The swizzled word-major layout is a permutation of the tile, every
    pass touches each position once, and in every exchange each warp's 32
    accesses of one word fall in 32 different banks (no conflict)."""
    swz, T = _swizzle(), 1 << tlog
    assert sorted(swz(i) for i in range(T)) == list(range(T))
    worst = 0
    for items in _exchanges(T):
        assert sorted(p for it in items for p in it) == list(range(T))
        for w0 in range(0, len(items), 32):
            warp = items[w0:w0 + 32]
            for slot in range(len(warp[0])):
                banks = np.bincount([swz(it[slot]) % 32 for it in warp])
                worst = max(worst, int(banks.max()))
    assert worst == 1


# -- the NTT pass kernel's layout and exchanges -----------------------------------

def _source_int(name):
    src = (CSRC / "fr_ntt.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _pass_swizzle():
    src = (CSRC / "fr_ntt.cu").read_text()
    body = re.search(r"int pass_swz\(int i, int clog\) \{\s*return ([^;]+);",
                     src).group(1)
    assert re.fullmatch(r"[\sicolg()&|^*<>+0-9]+", body)
    return eval(f"lambda i, clog: {body}")    # C and Python agree on it


def _pass_exchanges(L, clog):
    """Per exchange of the pass kernel over L stages and 2^clog columns,
    the shared memory values (row x 2^clog + column) each work item
    touches: the first groups' stores (nv = 4 consecutive rows of a
    column), each radix-4 pair of stages (rows k + q 4h + {0, h, 2h, 3h}),
    an odd last stage alone (rows k, k + R / 2); 32 consecutive items
    form a warp, as in the kernel's loops."""
    C, V = 1 << clog, 1 << (L + clog)
    if L <= 2:                                 # no shared memory
        return []
    out = [[[((j >> clog) * 4 + k) << clog | (j & (C - 1)) for k in range(4)]
            for j in range(V // 4)]]
    i = 2
    while i + 1 < L:
        h = 1 << i
        items = []
        for j in range(V // 4):
            c, jj = j & (C - 1), j >> clog
            r0 = ((jj >> i) << (i + 2)) | (jj & (h - 1))
            items.append([(r0 + q * h) << clog | c for q in range(4)])
        out.append(items)
        i += 2
    if i == L - 1:
        h = 1 << i
        out.append([[(j >> clog) << clog | (j & (C - 1)),
                     ((j >> clog) + h) << clog | (j & (C - 1))]
                    for j in range(V // 2)])
    return out


def _pass_col_logs(L):
    """The columns a block (log2) the C entry may choose for L stages:
    from 2^(kPassValuesLog - L) down to 2^kMinColLog, no fewer than one
    warp of first groups (`pass_col_log`)."""
    top, lo = _source_int("kPassValuesLog"), _source_int("kMinColLog")
    nvlog = 2 if L >= 2 else 1
    return range(max(lo, 5 + nvlog - L), top - L + 1)


@pytest.mark.parametrize("L", range(1, 8))
def test_pass_exchanges_hit_distinct_banks(L):
    """For every number of stages a pass takes (1 .. kPassLog) and every
    block width the launch may choose, the swizzled word-major layout is
    a permutation of the block's values, every exchange touches each
    value once, and each warp's 32 accesses of one word fall in 32
    different banks (no conflict)."""
    assert L <= _source_int("kPassLog")
    swz = _pass_swizzle()
    for clog in _pass_col_logs(L):
        V = 1 << (L + clog)
        assert sorted(swz(i, clog) for i in range(V)) == list(range(V))
        worst = 0
        for items in _pass_exchanges(L, clog):
            assert sorted(p for it in items for p in it) == list(range(V))
            for w0 in range(0, len(items), 32):
                warp = items[w0:w0 + 32]
                for slot in range(len(warp[0])):
                    banks = np.bincount([swz(it[slot], clog) % 32
                                         for it in warp])
                    worst = max(worst, int(banks.max()))
        assert worst == (1 if L > 2 else 0)
