"""The MSM's layout and compaction (csrc/msm_layout.cu) through their plain
versions and wrappers, against the JAX package.

The reference's layout is glue inside its compiled `_msm_fn`
(`infimum_tpu/msm/pallas_msm.py:427-466`): the signed recode scan, each
window's stable `jax.lax.sort_key_val` of the digits against arange(N)
with the take of the signs, and the compaction. Here the port's plain
layout (`lane_layout_plain`, a stable `torch.sort`) is held against that
very sort_key_val call, run on the CPU on the same digits; a plain model
of the kernels' index arithmetic (block histograms, the bin-major scan,
in-block stable ranks by warp, the (nwin, L, T) placement) against the
stable sort; and the compaction's count / scan / write arithmetic against
`compact_plain` and a numpy walk lane by lane. Inputs come from numpy
seeds; every comparison is exact. The `cuda` tests hold each kernel
against its plain version on a card and skip without one."""

import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu_torch import kernels
from infimum_tpu_torch.curve.bn254_host import G1_GEN, G2_GEN, g1_mul, g2_mul
from infimum_tpu_torch.curve.proj import G1_DEV
from infimum_tpu_torch.groth16 import groth16 as G
from infimum_tpu_torch.msm import msm as M

torch.set_num_threads(1)  # the suite runs in parallel worker processes

CSRC = pathlib.Path(M.__file__).parents[1] / "csrc"
CASES = ("padding_rows", "all_equal", "half_digits", "r_minus_1",
         "ragged_blocks")


def _random_scalars(rng, n):
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % FR_MOD
            for row in words]


def _case_scalars(case, spec, seed=0):
    """The scalars of one edge case of the layout; a multiple of 8 of them
    (the lanes the tests lay them out on)."""
    rng = np.random.default_rng(seed)
    c, half = spec.c_bits, spec.n_buckets
    if case == "padding_rows":            # a query padded with zero rows
        return _random_scalars(rng, 40) + [0] * 160
    if case == "all_equal":               # every window's digits equal
        return _random_scalars(rng, 1) * 96
    if case == "half_digits":
        # window 0 at 2^(c-1) (no carry-in); window 1 at 2^(c-1) with no
        # carry-in, at 2^(c-1) - 1 + carry-in 1, at 2^(c-1) + carry-in
        # (negative), and carries passed on through a window at 2^(c-1)
        edge = [half, half << c, ((half - 1) << c) | (half + 1),
                (half << c) | (half + 1),
                (half + 1) | (half << c) | (half << 2 * c)]
        return edge * 24 + _random_scalars(rng, 80)
    if case == "r_minus_1":
        return [FR_MOD - 1] * 40 + _random_scalars(rng, 40) + [FR_MOD - 1] * 8
    if case == "ragged_blocks":           # N not a multiple of the chunk
        n = 2 * spec.layout_chunk + 1000
        sc = _random_scalars(rng, n)
        for i in range(0, n, 3):
            sc[i] = 0
        return sc
    raise ValueError(case)


def _layout_inputs(case, spec):
    scs = _case_scalars(case, spec)
    assert len(scs) % 8 == 0
    sc = M.ints_to_tensor(scs, "cpu")
    rows = torch.zeros((len(scs), spec.AW), dtype=torch.int32)
    return rows, sc


def test_layout_constants_match_source():
    """The chunk of entries a block, the warps a scatter block and the
    lanes a compaction block of the plain models are the kernels'
    compiled-in ones."""
    src = (CSRC / "msm_layout.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kChunkG1") == M.G1_SPEC.layout_chunk
    assert const("kChunkG2") == M.G2_SPEC.layout_chunk
    assert const("kScatterWarps") == M.SCATTER_WARPS
    assert const("kCompactThreads") == COMPACT_THREADS
    assert re.search(r"Windows<13, kChunkG1>", src)
    assert re.search(r"Windows<10, kChunkG2>", src)
    assert M.G1_SPEC.c_bits == 13 and M.G2_SPEC.c_bits == 10


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_plain_layout_matches_reference_sort(curve, case):
    """Each window of the plain layout equals the reference's own stable
    sort, `jax.lax.sort_key_val(digits, arange(N))` (pallas_msm.py:446),
    on the same digits, and its signs the take of :449."""
    spec = M.SPECS[curve]
    rows, sc = _layout_inputs(case, spec)
    n, lanes = sc.shape[0], 8
    sdig, ssgn, order, words = M.lane_layout_plain(rows, sc, lanes, spec)
    assert sdig.shape == (spec.n_windows, lanes, n // lanes)
    assert words is rows
    mags, sgns = M.recode(sc, spec)
    ref_sort = jax.jit(lambda d: jax.lax.sort_key_val(
        d, jnp.arange(d.shape[0], dtype=jnp.int32)))
    for w in range(spec.n_windows):
        r_dig, r_ord = ref_sort(jnp.asarray(mags[w].numpy().astype(np.uint32)))
        r_sgn = jnp.take(jnp.asarray(sgns[w].numpy().astype(np.uint32)),
                         r_ord, axis=0)
        assert np.array_equal(sdig[w].flatten().numpy(), np.asarray(r_dig))
        assert np.array_equal(order[w].flatten().numpy(), np.asarray(r_ord))
        assert np.array_equal(ssgn[w].flatten().numpy(), np.asarray(r_sgn))
    if case == "half_digits":             # the edge digits are there
        assert (mags == spec.n_buckets).any(1)[:2].all()
        assert ((mags == spec.n_buckets - 1) & (sgns == 1)).any()


def _emulated_scatter(packed, offsets, totals, spec):
    """The scatter kernel's arithmetic walked as the card runs it: per
    (block, window), each of SCATTER_WARPS warps counts its range per bin,
    the warps' counts are scanned in warp order, then each warp takes its
    entries 32 at a time, an entry's rank the lanes below it with its digit
    (__match_any_sync + __popc) plus its warp's running count; the digits
    of the block's range of sorted positions are the marks of the bins
    starting there, filled by a running maximum from the bin holding the
    range's first position."""
    nwin, n = packed.shape
    chunk, nw, bins = spec.layout_chunk, M.SCATTER_WARPS, spec.n_buckets + 1
    per_warp = chunk // nw
    mags = (packed.numpy().astype(np.int64) & 0x7FFF)
    sgn = (packed.numpy() < 0).astype(np.int32)
    tot = totals.numpy().astype(np.int64)
    base = np.cumsum(tot, 1) - tot
    out = np.full((3, nwin, n), -1, dtype=np.int64)
    for w in range(nwin):
        for b in range(-(-n // chunk)):
            ranges = [(min(n, b * chunk + k * per_warp),
                       min(n, b * chunk + (k + 1) * per_warp))
                      for k in range(nw)]
            counts = np.stack([np.bincount(mags[w, lo:hi], minlength=bins)
                               for lo, hi in ranges])
            running = np.cumsum(counts, 0) - counts       # warps in order
            first = base[w] + offsets[w, b].numpy()
            for k, (lo, hi) in enumerate(ranges):
                for g in range(lo, hi, 32):
                    d = mags[w, g:min(hi, g + 32)]
                    lower = (d[None, :] == d[:, None]) & np.tri(
                        len(d), k=-1, dtype=bool)
                    dest = first[d] + running[k, d] + lower.sum(1)
                    out[1, w, dest] = sgn[w, g:g + len(d)]
                    out[2, w, dest] = np.arange(g, g + len(d))
                    np.add.at(running[k], d, 1)
            s_lo, s_hi = b * chunk, min(n, (b + 1) * chunk)
            starts = (base[w] >= s_lo) & (base[w] < s_hi) & (tot[w] > 0)
            mark = np.zeros(chunk, np.int64)
            mark[base[w][starts] - s_lo] = np.nonzero(starts)[0]
            held = np.searchsorted(base[w], s_lo, side="right") - 1
            out[0, w, s_lo:s_hi] = np.maximum.accumulate(
                np.maximum(mark, held))[:s_hi - s_lo]
    assert (out >= 0).all()               # every slot written
    return [torch.from_numpy(o.astype(np.int32)) for o in out]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_model_matches_stable_sort(curve, case):
    """The kernels' plain versions in turn (block histograms, the scan over
    blocks in place, the scatter's slot arithmetic), and the scatter walked
    warp by warp as the card does, equal the stable sort of
    `lane_layout_plain`, in the (nwin, L, T) layout."""
    spec = M.SPECS[curve]
    rows, sc = _layout_inputs(case, spec)
    n, lanes = sc.shape[0], 8
    want = M.lane_layout_plain(rows, sc, lanes, spec)
    packed, counts = M.layout_recode(sc, spec)
    nblk = M.layout_blocks(n, spec)
    assert packed.dtype == torch.int16 and packed.shape == (spec.n_windows, n)
    assert counts.shape == (spec.n_windows, nblk, spec.n_buckets + 1)
    mags, sgns = M.recode(sc, spec)
    assert torch.equal((packed & 0x7FFF).to(torch.int32), mags)
    assert torch.equal((packed < 0).to(torch.int32), sgns)
    for b in range(nblk):                 # each block's histogram
        blk = mags[:, b * spec.layout_chunk:(b + 1) * spec.layout_chunk]
        for w in range(spec.n_windows):
            assert torch.equal(counts[w, b], torch.bincount(
                blk[w], minlength=spec.n_buckets + 1).to(torch.int32))
    raw = counts.clone()
    totals = M.layout_scan(counts)
    assert torch.equal(totals, raw.sum(1).to(torch.int32))
    assert torch.equal(counts[:, 0], torch.zeros_like(counts[:, 0]))
    assert torch.equal(counts[:, 1:], raw[:, :-1].cumsum(1).to(torch.int32))
    got = M.layout_scatter(packed, counts, totals, spec)
    walked = _emulated_scatter(packed, counts, totals, spec)
    for g, e, w in zip(got, walked, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        assert torch.equal(g.view(w.shape), w)
        assert torch.equal(e.view(w.shape), w)
    if case == "ragged_blocks":
        assert nblk == 3 and n % spec.layout_chunk


def _emissions(seed, nwin, T1, PW, L, live):
    """Random emissions: edig (nwin, T1, L) with about `live` of them
    nonzero (digits non-decreasing along each lane, as the accumulation
    emits them), ept (nwin, T1, PW, L) random words."""
    rng = np.random.default_rng(seed)
    alive = rng.random((nwin, L, T1)) < live
    digits = np.cumsum(rng.integers(1, 4, size=(nwin, L, T1)), -1)
    edig = np.where(alive, digits, 0).transpose(0, 2, 1)
    ept = rng.integers(-(1 << 31), 1 << 31, size=(nwin, T1, PW, L),
                       dtype=np.int64)
    return (torch.from_numpy(np.ascontiguousarray(edig).astype(np.int32)),
            torch.from_numpy(ept.astype(np.int32)))


def _compact_walk(edig, ept, K):
    """A numpy walk, window by window, lane by lane, t rising."""
    nwin, T1, PW, L = ept.shape
    cdig = np.zeros((nwin, K), np.int32)
    cpts = np.zeros((nwin, PW, K), np.int32)
    for w in range(nwin):
        slot = 0
        for l in range(L):
            for t in range(T1):
                if edig[w, t, l] > 0:
                    cdig[w, slot] = edig[w, t, l]
                    cpts[w, :, slot] = ept[w, t, :, l]
                    slot += 1
    return torch.from_numpy(cdig), torch.from_numpy(cpts)


COMPACT_THREADS = 256       # = kCompactThreads, msm_layout.cu


def _compact_model(edig, ept, K):
    """The compaction kernel's arithmetic: the first grid counts each lane's
    live emissions; a block of the second takes its first slot from the
    lanes before it, its lanes' slots by an exclusive scan, copies each
    lane's live emissions in t order, and zeroes its share of the slots
    above the window's live ones."""
    nwin, T1, PW, L = ept.shape
    lanecnt = (edig > 0).sum(1)                          # (nwin, L)
    cdig = torch.full((nwin, K), -7, dtype=torch.int32)  # unwritten: -7
    cpts = torch.full((nwin, PW, K), -7, dtype=torch.int32)
    nblocks = -(-L // COMPACT_THREADS)
    for w in range(nwin):
        live = min(int(lanecnt[w].sum()), K)
        share = -(-(K - live) // nblocks)
        for b in range(nblocks):
            lanes = range(b * COMPACT_THREADS, min(L, (b + 1) * COMPACT_THREADS))
            slot = int(lanecnt[w, :lanes.start].sum())
            for l in lanes:
                for t in range(T1):
                    if edig[w, t, l] > 0:
                        if slot < K:
                            cdig[w, slot] = edig[w, t, l]
                            cpts[w, :, slot] = ept[w, t, :, l]
                        slot += 1
            z0 = live + b * share
            cdig[w, z0:min(K, z0 + share)] = 0
            cpts[w, :, z0:min(K, z0 + share)] = 0
    return cdig, cpts


COMPACT_CASES = {        # (nwin, T1, L, live share, K over the most live)
    "sparse_two_blocks": (3, 9, 512, 0.05, 5),
    "dense": (2, 6, 8, 0.9, 3),
    "all_dead": (2, 4, 264, 0.0, 9),
    "exact_fit": (3, 7, 300, 0.3, 0),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_compact_model_matches_plain(curve, case):
    """The compaction kernel's count / scan / write arithmetic equals
    `compact_plain` (the reference's flags, cumsum and scatter) and a
    numpy walk lane by lane; every slot is written."""
    spec = M.SPECS[curve]
    nwin, T1, L, live, spare = COMPACT_CASES[case]
    edig, ept = _emissions(len(case), nwin, T1, spec.PW, L, live)
    K = int((edig > 0).sum((1, 2)).max()) + spare
    want = _compact_walk(edig.numpy(), ept.numpy(), K)
    plain = M.compact_plain(edig, ept, K)
    model = _compact_model(edig, ept, K)
    routed = M.compact(edig, ept, K)          # a CPU tensor: the plain one
    for got in (plain, model, routed):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    if case == "exact_fit":
        assert (want[0] > 0).sum(1).max() == K


def test_query_words_cached_once(monkeypatch):
    """A query's table is encoded as words once per key and device; the
    accumulation reads them as they are, and a layout of the words equals
    one of the limbs it came from."""
    pts = [g1_mul(G1_GEN, k + 2) for k in range(13)] + [None, None]
    key = types.SimpleNamespace()
    words, mask, lanes = G._query_encoding(key, "a", pts, G1_DEV, "cpu")
    rows = M.encode_rows([G1_GEN if p is None else p for p in pts], lanes)
    assert words.dtype == torch.int32 and words.shape == (16, M.G1_SPEC.AW)
    assert torch.equal(words, M.limbs_to_words(rows))
    assert mask.tolist() == [False] * 13 + [True, True]
    calls = []
    monkeypatch.setattr(G, "encode_rows",
                        lambda *a, **k: calls.append(a) or rows)
    again = G._query_encoding(key, "a", pts, G1_DEV, "cpu")
    assert again[0] is words and not calls
    spec = M.G1_SPEC
    sc = M.ints_to_tensor(_random_scalars(np.random.default_rng(3), 16), "cpu")
    by_words = M.lane_layout(words, sc, lanes, spec)
    by_limbs = M.lane_layout(rows, sc, lanes, spec)
    assert by_words[3] is words
    for a, b in zip(by_words, by_limbs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="words"):
        M.table_words(words[:, :8].contiguous(), spec)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_from_words_equals_limbs(curve):
    """`msm_rows_async` gives the same window sums from the table's words
    as from its limbs, through the routed wrappers (the plain versions on
    the CPU)."""
    spec = M.SPECS[curve]
    gen, mul = (G1_GEN, g1_mul) if curve == "g1" else (G2_GEN, g2_mul)
    pts = [mul(gen, k + 3) for k in range(24)]
    scs = _random_scalars(np.random.default_rng(5), 24)
    rows, sc = M.encode_inputs(pts, scs, 8, curve)
    a = M.msm_rows_async(rows, sc, 8, curve)
    b = M.msm_rows_async(M.limbs_to_words(rows), sc, 8, curve)
    assert a.shape == (spec.n_windows, spec.PR)
    assert torch.equal(a, b)


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layout kernels run only on a card")
    return "cuda"


def _card_scalars(n, seed, device):
    """n scalars from a seed, a third of them zero (the padding rows and
    infinity points of a query), as (n, 16) limbs on `device`."""
    sc = _random_scalars(np.random.default_rng(seed), n)
    for i in range(0, n, 3):
        sc[i] = 0
    return M.ints_to_tensor(sc, device)


LAYOUT_SHAPES = {"multi_block": (None, 8), "h_2^18": (1 << 18, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(LAYOUT_SHAPES))
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_layout_kernels_match_plain_on_card(cuda_device, curve, shape):
    """Each layout kernel equals its plain version on the same card
    tensors, bit for bit, at a ragged multi-block shape and at the 2^18
    shape of the process key's `h` query (G1: 4,096 lanes); and
    `lane_layout` launches each kernel once and equals `lane_layout_plain`
    (the stable torch.sort)."""
    spec = M.SPECS[curve]
    n, lanes = LAYOUT_SHAPES[shape]
    n = n or 2 * spec.layout_chunk + 1000
    sc = _card_scalars(n, 11 + n, cuda_device)
    packed, counts = M.layout_recode(sc, spec)
    p_packed, p_counts = M.layout_recode_plain(sc, spec)
    assert torch.equal(packed, p_packed)
    assert torch.equal(counts, p_counts)
    offsets, p_offsets = counts.clone(), counts.clone()
    totals = M.layout_scan(offsets)
    p_totals = M.layout_scan_plain(p_offsets)
    assert torch.equal(totals, p_totals)
    assert torch.equal(offsets, p_offsets)
    got = M.layout_scatter(packed, offsets, totals, spec)
    want = M.layout_scatter_plain(packed, offsets, totals, spec)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows = torch.zeros((n, spec.AW), dtype=torch.int32, device=cuda_device)
    kernels.reset_counts()
    lay = M.lane_layout(rows, sc, lanes, spec)
    torch.cuda.synchronize()
    counted = kernels.launch_counts()
    assert {k: counted[k] for k in (f"msm_recode_{curve}", "msm_scan",
                                    f"msm_scatter_{curve}")} == {
        f"msm_recode_{curve}": 1, "msm_scan": 1, f"msm_scatter_{curve}": 1}
    for g, w in zip(lay, M.lane_layout_plain(rows, sc, lanes, spec)):
        assert torch.equal(g, w)


COMPACT_SHAPES = {"small": (3, 9, 512), "h_2^18": (None, 65, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(COMPACT_SHAPES))
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_compact_kernel_matches_plain_on_card(cuda_device, curve, shape):
    """The compaction kernel equals `compact_plain` on the same card
    tensors, bit for bit, at a small two-block shape and at the 2^18 `h`
    shape (T + 1 = 65, 4,096 lanes), the live emissions about 90% of the
    K slots the sorted order bounds them by (3% and 1.6% of all at
    `h`)."""
    spec = M.SPECS[curve]
    nwin, T1, L = COMPACT_SHAPES[shape]
    nwin = nwin or spec.n_windows
    K = spec.n_buckets + L + 2
    edig, ept = _emissions(T1, nwin, T1, spec.PW, L, 0.9 * K / (T1 * L))
    edig, ept = edig.to(cuda_device), ept.to(cuda_device)
    assert int((edig > 0).sum((1, 2)).max()) <= K
    kernels.reset_counts()
    got = M.compact(edig, ept, K)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[f"msm_compact_{curve}"] == 1
    want = M.compact_plain(edig, ept, K)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_through_layout_kernels_on_card(cuda_device, curve):
    """A whole MSM on the card through `msm_rows_async` (the layout,
    accumulation, compaction and weighted kernels) equals, limb for limb,
    the same MSM with the layout's and the compaction's plain versions in
    their places, and combines to the host's result."""
    spec = M.SPECS[curve]
    gen, mul = (G1_GEN, g1_mul) if curve == "g1" else (G2_GEN, g2_mul)
    pts = [mul(gen, k + 3) for k in range(64)] * 64
    scs = _random_scalars(np.random.default_rng(9), len(pts))
    rows, sc = M.encode_inputs(pts, scs, 128, curve, cuda_device)
    words = M.limbs_to_words(rows)
    got = M.msm_rows_async(words, sc, 128, curve)
    edig, ept = M.accumulate(*M.lane_layout_plain(words, sc, 128, spec), spec)
    cdig, cpts = M.compact_plain(edig, ept, spec.n_buckets + 128 + 2)
    want = M.words_to_limbs(M.weighted_sum(cdig, cpts, spec))
    assert torch.equal(got, want)
    total = None
    for p, s in zip(pts, scs):
        total = spec.curve.host_add(total, spec.curve.host_mul(p, s))
    assert M.combine_window_points(got.cpu(), curve) == total
