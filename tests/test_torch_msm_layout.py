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
stable sort; the recode launch from the scalars' words (pairs of rows a
thread, window groups, the padding and the infinity mask, the grid-wide
scan) walked item by item against the plain recode and scan, and the
words recode against the limbs one and the reference's own recode scan;
and the compaction's count / scan / write arithmetic against
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
    assert const("kRecodeThreads") == RECODE_THREADS
    assert const("kGroupG1") == M.G1_SPEC.recode_group
    assert const("kGroupG2") == M.G2_SPEC.recode_group
    assert re.search(r"Windows<13, kChunkG1, kGroupG1>", src)
    assert re.search(r"Windows<10, kChunkG2, kGroupG2>", src)
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


LANES = np.arange(32, dtype=np.uint64)
BELOW = (np.uint64(1) << LANES) - np.uint64(1)     # each lane's lower lanes
FULL = np.uint64(0xFFFFFFFF)


def _ballot_peers(d, bits):
    """The scatter's rank by ballots for one warp of 32 digits (d <
    2^bits): one ballot a bit (the lanes whose bit is set), each lane's
    peers the AND of the ballots it agrees with -> (32,) uint64 masks."""
    m = np.full(32, FULL, np.uint64)
    for b in range(bits):
        on = ((d >> b) & 1).astype(bool)
        v = np.uint64(int((on.astype(np.uint64) << LANES).sum()))
        m &= np.where(on, v, ~v & FULL)
    return m


def _emulated_scatter(packed, offsets, totals, spec, staged=None):
    """The scatter kernel's arithmetic walked as the card runs it, block by
    block (window, block of entries): each of SCATTER_WARPS warps counts
    its range per bin (shared atomics: the order of the adds is free);
    each bin's first position in the block is the block's counts scanned
    over the bins, and each warp's that plus the counts of the warps
    before it; each warp then stages its entries, 32 at a time, at its
    position of their bin plus their rank (their peers in lower lanes,
    `_ballot_peers`), a word of the packed digit above the entry's offset
    in the block, the lowest lane of each digit moving the warp's
    position on by its peers; staged entry j goes to slot j + delta[bin],
    delta the bin's first slot in this block (its window offset plus the
    block's offset in it) less its first block-local position. The
    digits of the block's range of sorted positions are the marks of the
    bins starting there, filled by a running maximum from the bin holding
    the range's first position. `staged` collects (window, block, staged
    words) of each block."""
    nwin, n = packed.shape
    chunk, nw, bins = spec.layout_chunk, M.SCATTER_WARPS, spec.n_buckets + 1
    per_warp = chunk // nw
    pk = packed.numpy().astype(np.int64) & 0xFFFF
    mags = pk & 0x7FFF
    tot = totals.numpy().astype(np.int64)
    base = np.cumsum(tot, 1) - tot
    out = np.full((3, nwin, n), -1, dtype=np.int64)
    for w in range(nwin):
        for b in range(-(-n // chunk)):
            b_lo, b_hi = b * chunk, min(n, (b + 1) * chunk)
            cnt = np.zeros((nw, bins), np.int64)
            groups = []
            for k in range(nw):
                lo, hi = b_lo + k * per_warp, min(n, b_lo + (k + 1) * per_warp)
                cnt[k] = np.bincount(mags[w, lo:hi], minlength=bins)
                for g in range(lo, hi, 32):
                    d = np.full(32, bins, np.int64)          # the end sentinel
                    d[:min(hi, g + 32) - g] = mags[w, g:min(hi, g + 32)]
                    groups.append((k, g, d, _ballot_peers(d, spec.c_bits)))
            total = cnt.sum(0)
            start = np.cumsum(total) - total   # bins' first block positions
            pos = start + np.cumsum(cnt, 0) - cnt          # each warp's
            stage = np.full(b_hi - b_lo, -1, np.int64)
            for k, g, d, m in groups:
                real = d < bins
                idx = np.arange(g, g + 32)[real]
                at = pos[k, d[real]] + np.bitwise_count(m & BELOW)[real]
                stage[at] = (pk[w, idx] << 16) | (idx - b_lo)
                lead = real & ((m & BELOW) == 0)
                np.add.at(pos[k], d[lead], np.bitwise_count(m[lead]))
            assert (stage >= 0).all()             # every position staged
            assert (pos[-1] == start + total).all()
            if staged is not None:
                staged.append((w, b, stage))
            delta = base[w] + offsets[w, b].numpy() - start
            dest = np.arange(b_hi - b_lo) + delta[(stage >> 16) & 0x7FFF]
            out[1, w, dest] = stage >> 31
            out[2, w, dest] = b_lo + (stage & 0xFFFF)
            starts = (base[w] >= b_lo) & (base[w] < b_hi) & (tot[w] > 0)
            mark = np.zeros(chunk, np.int64)
            mark[base[w][starts] - b_lo] = np.nonzero(starts)[0]
            held = np.searchsorted(base[w], b_lo, side="right") - 1
            out[0, w, b_lo:b_hi] = np.maximum.accumulate(
                np.maximum(mark, held))[:b_hi - b_lo]
    assert (out >= 0).all()               # every slot written
    return [torch.from_numpy(o.astype(np.int32)) for o in out]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_kernel_model_matches_stable_sort(curve, case):
    """The kernels' plain versions in turn (the recode's block histograms
    and their scan over blocks in place, the scatter's slot arithmetic),
    the routed recode (its plain versions on the CPU), and the scatter walked
    warp by warp as the card does, equal the stable sort of
    `lane_layout_plain`, in the (nwin, L, T) layout."""
    spec = M.SPECS[curve]
    rows, sc = _layout_inputs(case, spec)
    n, lanes = sc.shape[0], 8
    want = M.lane_layout_plain(rows, sc, lanes, spec)
    packed, counts = M.layout_recode_plain(sc, spec)
    nblk = M.layout_blocks(n, spec)
    assert packed.dtype == torch.int16 and packed.shape == (spec.n_windows, n)
    assert counts.shape == (spec.n_windows, nblk, spec.n_buckets + 1)
    routed = M.layout_recode(sc, spec)    # a CPU tensor: the plain ones
    assert torch.equal(routed[0], packed)
    mags, sgns = M.recode(sc, spec)
    assert torch.equal((packed & 0x7FFF).to(torch.int32), mags)
    assert torch.equal((packed < 0).to(torch.int32), sgns)
    for b in range(nblk):                 # each block's histogram
        blk = mags[:, b * spec.layout_chunk:(b + 1) * spec.layout_chunk]
        for w in range(spec.n_windows):
            assert torch.equal(counts[w, b], torch.bincount(
                blk[w], minlength=spec.n_buckets + 1).to(torch.int32))
    raw = counts.clone()
    totals = M.layout_scan_plain(counts)
    assert torch.equal(routed[1], counts) and torch.equal(routed[2], totals)
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


# -- the recode launch: from the scalars' words to the scatter's inputs -------

RECODE_THREADS = 512        # = kRecodeThreads, msm_layout.cu
WORD_CASES = ("padding_rows", "masked_rows", "zero_scalars", "below_r",
              "c_slice")
NPUB = 10                   # the process circuit's public values and one


def _word_case(case, spec, seed=0):
    """(words (n, 8) int32, rows, mask or None) of one case of the recode
    from words: rows >= n, a multiple of 8; n odd where it can be."""
    rng = np.random.default_rng(seed + len(case))
    chunk = spec.layout_chunk
    if case == "padding_rows":            # two blocks, then zero rows
        scs, rows, mask = _random_scalars(rng, chunk + 777), 3 * chunk, None
    elif case == "masked_rows":           # a query's infinity points
        n = 2 * chunk + 301
        scs, rows = _random_scalars(rng, n), 2 * chunk + 400
        mask = torch.from_numpy(rng.random(rows) < 0.3)
    elif case == "zero_scalars":
        scs = [0 if k % 3 else s for k, s in
               enumerate(_random_scalars(rng, chunk + 5))]
        rows, mask = chunk + 8, None
    elif case == "below_r":               # r - 1, r - 2, ... and randoms
        scs = [FR_MOD - 1 - k for k in range(600)] + _random_scalars(rng, 401)
        rows, mask = 1008, torch.from_numpy(rng.random(1001) < 0.1)
    elif case == "c_slice":               # the c query's slice at npub
        full = M.ints_to_tensor(_random_scalars(rng, chunk + NPUB + 31),
                                "cpu")
        words = M.limbs_to_words(full)[NPUB:]
        assert words.storage_offset() == NPUB * 8 and words.is_contiguous()
        return words, chunk + 40, torch.from_numpy(
            rng.random(chunk + 31) < 0.2)
    else:
        raise ValueError(case)
    return M.limbs_to_words(M.ints_to_tensor(scs, "cpu")), rows, mask


def _reference_recode(limbs, curve):
    """The JAX package's own recode scan (pallas_msm.py:427-442), its
    `recode` step taken from `_msm_fn`'s code as it stands and run by
    `jax.lax.scan` over the windows, on (N, 16) limbs -> (mags, sgns)."""
    import types

    from infimum_tpu.msm import pallas_msm as ref

    def code(c, name):
        return next(k for k in c.co_consts
                    if isinstance(k, types.CodeType) and k.co_name == name)

    step = code(code(ref._msm_fn.__wrapped__.__code__, "run"), "recode")
    spec = ref._SPECS[curve]
    sc = jnp.asarray(limbs.numpy().astype(np.uint32))
    env = {"spec": spec, "sc": sc, "half": jnp.uint32(spec.n_buckets),
           "full": jnp.uint32(2 * spec.n_buckets)}
    fn = types.FunctionType(step, ref.__dict__, "recode", None, tuple(
        types.CellType(env[v]) for v in step.co_freevars))
    _, (mags, sgns) = jax.lax.scan(fn, jnp.zeros((sc.shape[0],), jnp.uint32),
                                   jnp.arange(spec.n_windows,
                                              dtype=jnp.uint32))
    return (torch.from_numpy(np.asarray(mags).astype(np.int32)),
            torch.from_numpy(np.asarray(sgns).astype(np.int32)))


@pytest.mark.parametrize("case", WORD_CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_words_recode_matches_limbs_and_reference(curve, case):
    """The recode from the scalars' words with the query's rows and
    infinity mask (the plain version, and the routed wrapper on the CPU)
    equals the limbs path the prover took before (a padded, masked int64
    copy) and the JAX package's own recode scan on that copy: packed
    digits, block histograms, offsets and totals."""
    spec = M.SPECS[curve]
    words, rows, mask = _word_case(case, spec)
    n = words.shape[0]
    limbs = torch.zeros((rows, 16), dtype=torch.int64)
    limbs[:n] = M.words_to_limbs(words)
    if mask is not None:
        limbs[:n][mask[:n]] = 0
    packed, counts = M.layout_recode_plain(words, spec, rows, mask)
    want_packed, want_counts = M.layout_recode_plain(limbs, spec)
    assert torch.equal(packed, want_packed)
    assert torch.equal(counts, want_counts)
    r_mags, r_sgns = _reference_recode(limbs, curve)
    assert torch.equal((packed & 0x7FFF).to(torch.int32), r_mags)
    assert torch.equal((packed < 0).to(torch.int32), r_sgns)
    routed = M.layout_recode(words, spec, rows, mask)
    totals = M.layout_scan_plain(counts)
    for got, want in zip(routed, (packed, counts, totals)):
        assert torch.equal(got, want)
    zeros = int((r_mags == 0).sum())
    assert int(totals[:, 0].sum()) == zeros
    if case == "padding_rows":
        assert (packed[:, n:] == 0).all() and rows - n > spec.layout_chunk
    if case == "below_r":         # the top window of r - k is live, unmasked
        assert (r_mags[-1, :600] > 0).equal(~mask[:600])


def _recode_words(words, spec):
    """The kernel's digit arithmetic on (n, 8) words (`raw_digit`,
    `recode_digit`), windows in order with the carry: packed (nwin, n)
    int64 uint16. Checks its lookahead (`carry_into`) against the carry
    into every window."""
    w = np.concatenate([words.numpy().view(np.uint32).astype(np.int64),
                        np.zeros((words.shape[0], 1), np.int64)], 1)
    c, half = spec.c_bits, spec.n_buckets
    carry = np.zeros(words.shape[0], np.int64)
    out, raws = [], []
    for win in range(spec.n_windows):
        ahead = np.zeros_like(carry)           # carry_into: nearest raw
        open_ = np.ones(carry.shape, bool)     # digit below not at half
        for r in raws[::-1]:
            ahead = np.where(open_ & (r != half), r > half, ahead)
            open_ &= r == half
        assert (ahead == carry).all()
        bit = c * win
        k, s = bit // 32, bit % 32
        raw = w[:, k] >> s
        if s + c > 32:
            raw |= w[:, k + 1] << (32 - s)
        raws.append(raw & ((1 << c) - 1))
        d = raws[-1] + carry
        carry = (d > half).astype(np.int64)
        out.append(np.where(carry == 1, 2 * half - d, d) | carry << 15)
    return np.stack(out)


def _recode_launch(words, rows, mask, spec, grid):
    """The recode launch walked as the card runs it: a grid
    of `grid` blocks walks items it = blockIdx.x + k grid of (block of
    rows, window group), group fastest. An item zeroes its group's
    histograms, adds the padding rows [max(lo, n), hi) to bin 0 at once,
    then its threads take pairs of rows (2 t + 2 NT j from lo), each
    reading the words of a live unmasked row (zeros for a masked one),
    recoding the group's windows from the carry into its first (a
    lookahead, which `_recode_words` checks) and storing each window's
    pair of digits as one word while the pair's first row is below hi;
    each live digit counts (a warp's zeros summed into bin 0); the
    padding rows' pairs from the first even row at or above max(lo, n)
    get zero words. The histograms go to the item's rows of the counts.
    After the grid barrier, thread g of the grid scans columns g, g +
    grid NT, ... of (window, bin) over the blocks. Returns (packed int16,
    offsets, totals) and checks every word and column is written once
    (the padding's zero pairs may be written twice, both zero)."""
    nwin, bins, chunk = spec.n_windows, spec.n_buckets + 1, spec.layout_chunk
    G, NT = spec.recode_group, RECODE_THREADS
    ngroups, nblk = -(-nwin // G), -(-rows // chunk)
    n = words.shape[0]
    live = np.ones(n, bool) if mask is None else ~mask[:n].numpy()
    read = words.numpy() * live[:, None]        # masked rows: nothing read
    digits = _recode_words(torch.from_numpy(read), spec)
    pairs = np.full((nwin, rows // 2), -1, np.int64)   # -1: never written
    counts = np.full((nwin, nblk, bins), -1, np.int64)
    seen = np.zeros(nblk * ngroups, np.int64)
    for b in range(grid):
        for it in range(b, nblk * ngroups, grid):
            seen[it] += 1
            blk, grp = divmod(it, ngroups)
            w0, w1 = grp * G, min(nwin, grp * G + G)
            lo, hi = blk * chunk, min(rows, blk * chunk + chunk)
            live_hi = max(lo, min(hi, n))
            hist = np.zeros((w1 - w0, bins), np.int64)
            hist[:, 0] += hi - live_hi
            for i0 in range(lo, live_hi, 2 * NT):
                i = i0 + 2 * np.arange(NT)
                for win in range(w0, w1):
                    d = [np.where(j < live_hi, digits[win, np.minimum(
                        j, n - 1)], 0) for j in (i, i + 1)]
                    st = i < hi
                    assert (pairs[win, i[st] // 2] <= 0).all()
                    pairs[win, i[st] // 2] = d[0][st] | d[1][st] << 16
                    for j, dj in zip((i, i + 1), d):
                        m = dj[j < live_hi] & 0x7FFF
                        hist[win - w0] += np.bincount(m, minlength=bins)
            for i in range((live_hi + 1) & ~1, hi, 2):
                assert (pairs[w0:w1, i // 2] <= 0).all()
                pairs[w0:w1, i // 2] = 0
            counts[w0:w1, blk] = hist
    assert (seen == 1).all() and (pairs >= 0).all() and (counts >= 0).all()
    offsets, totals = counts.copy(), np.full((nwin, bins), -1, np.int64)
    cols = np.zeros(nwin * bins, np.int64)
    for g in range(grid * NT):
        for col in range(g, nwin * bins, grid * NT):
            cols[col] += 1
            win, b = divmod(col, bins)
            run = np.cumsum(counts[win, :, b])
            offsets[win, :, b] = run - counts[win, :, b]
            totals[win, b] = run[-1]
    assert (cols == 1).all()
    lo16 = pairs & 0xFFFF
    packed = np.stack([lo16, pairs >> 16], -1).reshape(nwin, rows)
    return (torch.from_numpy(packed.astype(np.uint16).view(np.int16)),
            torch.from_numpy(offsets.astype(np.int32)),
            torch.from_numpy(totals.astype(np.int32)))


@pytest.mark.parametrize("case", WORD_CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_recode_launch_model_matches_plain(curve, case):
    """The recode launch's items, pairs of rows, window groups, padding
    and mask, and its grid-wide scan, walked as the card runs them on a
    grid smaller than its items (blocks walk several) and on one of an
    item a block, equal the plain recode's packed digits and block
    histograms and `layout_scan_plain`'s offsets and totals."""
    spec = M.SPECS[curve]
    words, rows, mask = _word_case(case, spec)
    packed, counts = M.layout_recode_plain(words, spec, rows, mask)
    totals = M.layout_scan_plain(counts)
    items = M.layout_blocks(rows, spec) * -(-spec.n_windows //
                                           spec.recode_group)
    for grid in (3, items):
        got = _recode_launch(words, rows, mask, spec, grid)
        for g, w in zip(got, (packed, counts, totals)):
            assert torch.equal(g, w)


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
    """The compaction kernel's arithmetic, grid by grid: the count grid's
    live emissions a lane; the list grid's block of COMPACT_THREADS lanes
    takes its first slot from the lane counts before it and its lanes'
    slots by an exclusive scan, each live lane's emissions, t rising, to
    the next slots (its digit to cdig, its source t L + l to the slot
    list; slots from K on dropped), and gives its share of the slots above
    the window's live ones digit 0 and source -1; the gather grid's thread
    a (window, slot) copies its source's PW words of ept, or zeros.
    Returns (cdig, cpts, the slot list)."""
    nwin, T1, PW, L = ept.shape
    e, p = edig.numpy(), ept.numpy()
    lanecnt = (e > 0).sum(1)                             # the count grid
    cdig = np.full((nwin, K), -7, np.int64)              # unwritten: -7
    src = np.full((nwin, K), -7, np.int64)
    nblocks = -(-L // COMPACT_THREADS)
    for w in range(nwin):
        live = min(int(lanecnt[w].sum()), K)
        share = -(-(K - live) // nblocks)
        for b in range(nblocks):
            lanes = range(b * COMPACT_THREADS,
                          min(L, (b + 1) * COMPACT_THREADS))
            slot = int(lanecnt[w, :lanes.start].sum())
            for l in lanes:
                for t in np.nonzero(e[w, :, l] > 0)[0]:
                    if slot < K:
                        cdig[w, slot], src[w, slot] = e[w, t, l], t * L + l
                    slot += 1
            z0 = live + b * share
            cdig[w, z0:min(K, z0 + share)] = 0
            src[w, z0:min(K, z0 + share)] = -1
    assert (src != -7).all() and (cdig != -7).all()       # every slot written
    t, l = np.maximum(src, 0) // L, np.maximum(src, 0) % L
    cpts = p[np.arange(nwin)[:, None], t, :, l].transpose(0, 2, 1)
    cpts = np.where(src[:, None, :] >= 0, cpts, 0)
    return (torch.from_numpy(cdig.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(cpts).astype(np.int32)),
            src)


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
    model = _compact_model(edig, ept, K)[:2]
    routed = M.compact(edig, ept, K)          # a CPU tensor: the plain one
    for got in (plain, model, routed):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    if case == "exact_fit":
        assert (want[0] > 0).sum(1).max() == K


def _warp_digits(case, bins, rng):
    """32 digits of one warp in [0, bins], bins the end sentinel."""
    if case == "distinct":
        return rng.permutation(bins)[:32]
    if case == "equal":
        return np.full(32, rng.integers(bins))
    if case == "mixed":                   # a few digits, each in many lanes
        return rng.choice(rng.integers(0, bins, 5), 32)
    if case == "sentinel":                # a ragged warp: the end past lane 19
        d = rng.choice(np.array([0, 1, bins - 1, bins - 2]), 32)
        d[19:] = bins
        return d
    raise ValueError(case)


@pytest.mark.parametrize("case", ["distinct", "equal", "mixed", "sentinel"])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_ballot_rank_matches_match_any(curve, case):
    """The scatter's rank by ballots, one a bit of |digit| over c bits
    (the end sentinel 2^(c-1) + 1 fits), gives each lane the peers
    `__match_any_sync` gives, the lanes holding its digit; so its rank
    (its peers below it) counts the equal digits before it, and its
    leader (its lowest peer) is the first lane of its digit."""
    spec = M.SPECS[curve]
    bins = spec.n_buckets + 1
    assert bins < 1 << spec.c_bits
    rng = np.random.default_rng(len(case) + spec.c_bits)
    for _ in range(16):
        d = _warp_digits(case, bins + 1, rng)
        m = _ballot_peers(d, spec.c_bits)
        match_any = [sum(1 << int(j) for j in np.nonzero(d == x)[0])
                     for x in d]
        assert [int(x) for x in m] == match_any
        rank = np.bitwise_count(m & BELOW)
        assert rank.tolist() == [int((d[:i] == d[i]).sum())
                                 for i in range(32)]
        lead = (m & BELOW) == 0
        assert lead.tolist() == [d[i] not in d[:i] for i in range(32)]
    if case == "distinct":
        assert (m == (np.uint64(1) << LANES)).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_staged_write_matches_stable_sort(curve, case):
    """The scatter's staged words of each (window, block) item are the
    block's entries in stable order by |digit| (a stable sort of the
    block alone), each with its packed digit; so a bin's entries in the
    block take consecutive positions j and go to consecutive slots j +
    delta, and the slots equal the whole window's stable sort."""
    spec = M.SPECS[curve]
    rows, sc = _layout_inputs(case, spec)
    packed, counts, totals = M.layout_recode(sc, spec)
    staged = []
    got = _emulated_scatter(packed, counts, totals, spec, staged)
    n, chunk = sc.shape[0], spec.layout_chunk
    assert len(staged) == spec.n_windows * M.layout_blocks(n, spec)
    pk = packed.numpy().astype(np.int64) & 0xFFFF
    for w, b, stage in staged:
        block = pk[w, b * chunk:min(n, (b + 1) * chunk)]
        order = np.argsort(block & 0x7FFF, kind="stable")
        assert ((stage & 0xFFFF) == order).all()
        assert ((stage >> 16) == block[order]).all()
    mags, sgns = M.recode(sc, spec)
    sdig, perm = torch.sort(mags, dim=1, stable=True)
    assert torch.equal(got[0], sdig.to(torch.int32))
    assert torch.equal(got[1], sgns.gather(1, perm).to(torch.int32))
    assert torch.equal(got[2], perm.to(torch.int32))


SM_SHARED = 233472          # an H100 SM's shared memory, bytes
BLOCK_RESERVED = 1024       # of it reserved a resident block
WALK_SHAPES = {"a": ("g1", 143360), "b1": ("g1", 143360),
               "l": ("g1", 143360), "h": ("g1", 262144),
               "b2": ("g2", 141312)}


def _scatter_smem(spec):
    """The scatter's shared memory a block, as `scatter_smem` in
    msm_layout.cu sums it: 16-bit counters of 8 warps a bin, the bin
    offsets (bins + 1 words, padded to 16 bytes), a staged word an
    entry."""
    bins = spec.n_buckets + 1
    return bins * M.SCATTER_WARPS * 2 + ((bins + 4) & ~3) * 4 + \
        spec.layout_chunk * 4


@pytest.mark.parametrize("shape", sorted(WALK_SHAPES))
def test_scatter_grid_covers_each_item_once(shape):
    """At the five MSM shapes of a process proof, the scatter's grid, a
    block a (block of entries, window) in launch order, walks every item
    once: the blocks of a window tile its sorted positions [0, N), each
    writing the digits of its own range; and its shared memory (114,720
    bytes at G1, as the source's note sums it) lets two blocks onto an
    SM."""
    curve, n = WALK_SHAPES[shape]
    spec = M.SPECS[curve]
    src = (CSRC / "msm_layout.cu").read_text()
    assert re.search(r"msm_scatter_kernel<P><<<dim3\(nblk, P::kCount\)", src)
    nblk = M.layout_blocks(n, spec)
    seen = np.zeros((spec.n_windows, n), np.int64)
    for win in range(spec.n_windows):            # blockIdx.y
        for blk in range(nblk):                  # blockIdx.x
            lo, hi = blk * spec.layout_chunk, min(n, (blk + 1) *
                                                  spec.layout_chunk)
            seen[win, lo:hi] += 1
    assert (seen == 1).all()
    smem = _scatter_smem(spec)
    if curve == "g1":
        assert smem == 114720 and "114,720 bytes" in src
    assert 2 * (smem + BLOCK_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_compact_slot_list(curve):
    """The compaction's slot list holds, slot by slot, the source t L + l of
    each live emission in the order of `_compact_walk` (lane by lane, t
    rising), then -1; with its digits and words it equals
    `compact_plain`, for a window with no live emission, one with K live
    (every slot taken) and one in between, over several list blocks."""
    spec = M.SPECS[curve]
    nwin, T1, L = 3, 5, 4 * COMPACT_THREADS + 300
    edig, ept = _emissions(17, nwin, T1, spec.PW, L, 0.02)
    edig[0] = 0                                       # no live emission
    edig[2] = torch.where(torch.rand(T1, L, generator=torch.Generator()
                                     .manual_seed(3)) < 0.05, 5, 0)
    live = (edig > 0).sum((1, 2))
    K = int(live.max())
    assert live[0] == 0 and live[2] == K > live[1] > 0
    cdig, cpts, src = _compact_model(edig, ept, K)
    e = edig.numpy()
    for w in range(nwin):
        t, l = np.nonzero(e[w].T > 0)[1], np.nonzero(e[w].T > 0)[0]
        assert (src[w, :live[w]] == t * L + l).all()
        assert (src[w, live[w]:] == -1).all()
    want = _compact_walk(e, ept.numpy(), K)
    plain = M.compact_plain(edig, ept, K)
    for got in (want, plain):
        assert torch.equal(cdig, got[0])
        assert torch.equal(cpts, got[1])


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
    shape of the process key's `h` query (G1: 4,096 lanes): the recode
    launch (packed, offsets, totals) from limbs, from words with an
    infinity mask, and from fewer words than rows with the mask (its
    padding), then the scatter; and `lane_layout` launches the recode and
    the scatter once each and equals `lane_layout_plain` (the stable
    torch.sort)."""
    spec = M.SPECS[curve]
    n, lanes = LAYOUT_SHAPES[shape]
    n = n or 2 * spec.layout_chunk + 1000
    sc = _card_scalars(n, 11 + n, cuda_device)
    words = M.limbs_to_words(sc)
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < 0.2).to(
        cuda_device)
    for scalars, m in ((sc, None), (words, mask), (words[:n - 301], mask)):
        got = M.layout_recode(scalars, spec, n, m)
        p_packed, p_counts = M.layout_recode_plain(scalars, spec, n, m)
        p_totals = M.layout_scan_plain(p_counts)
        for g, w in zip(got, (p_packed, p_counts, p_totals)):
            assert torch.equal(g, w)
    packed, offsets, totals = got
    got = M.layout_scatter(packed, offsets, totals, spec)
    want = M.layout_scatter_plain(packed, offsets, totals, spec)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows = torch.zeros((n, spec.AW), dtype=torch.int32, device=cuda_device)
    kernels.reset_counts()
    lay = M.lane_layout(rows, words[:n - 301], lanes, spec, mask)
    torch.cuda.synchronize()
    counted = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counted == {f"msm_recode_{curve}": 1, f"msm_scatter_{curve}": 1}
    for g, w in zip(lay, M.lane_layout_plain(rows, words[:n - 301], lanes,
                                             spec, mask)):
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
