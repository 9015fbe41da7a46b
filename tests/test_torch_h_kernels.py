"""The port's H pipeline kernels (csrc/fr_rows.cu, csrc/fr_ntt.cu) through
their wrappers and plain versions, against the JAX package.

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the word-level pipeline the card runs (compressed rows with their
R^2 coefficient table, the tile with its gather modes and the pass
launches with their fused table multiplies, the pointwise step, the
witness converted once) against the reference's XLA programs: `_rows_fn`
(`eval_rows_device`), `_h_graph` (reached by `compute_h` below 2^13 rows),
the transforms of `infimum_tpu/ntt/ntt.py` and the zkey's odd-coset
steps. Inputs come from numpy seeds; every value is a reduced field
element, so every comparison is exact (tolerance 0). The `cuda` tests
hold each kernel against its plain version on a card and skip without
one."""

import pathlib
import random
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infimum_tpu.ff.bn254 import FR_MOD
from infimum_tpu.ff.fp import FR_CTX as REF_FR
from infimum_tpu.groth16 import groth16 as ref
from infimum_tpu.groth16 import zkey as ref_zkey
from infimum_tpu.groth16.r1cs import ConstraintSystem, LC
from infimum_tpu.groth16.rowval import SparseRows as RefRows, eval_rows_device
from infimum_tpu.ntt import ntt as ref_ntt
from infimum_tpu_torch import kernels
from infimum_tpu_torch.ff.fp import (
    FR_CTX, limbs_to_words, tensor_to_ints, to_tensor, words_to_limbs,
)
from infimum_tpu_torch.groth16 import groth16 as port
from infimum_tpu_torch.groth16 import rowval
from infimum_tpu_torch.groth16 import zkey as port_zkey
from infimum_tpu_torch.ntt import ntt as N

from test_groth16 import _cubic_circuit, _toy_circuit
from test_torch_rows_partition import KINDS, _matrices

torch.set_num_threads(1)  # the suite runs in parallel worker processes

P = FR_MOD
COSET_GEN = 5
NEW_KERNELS = ("fr_rows", "fr_ntt_tile", "fr_ntt_pass", "fr_pointwise")
CSRC = pathlib.Path(N.__file__).parents[1] / "csrc"


def _full_width(seed, n):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]


def _chain(n, seed):
    """out = x * prod_i (x + k_i) over n multiplications, full-width k_i:
    n + 3 QAP rows, so n = 10 gives a domain of 2^4 and n = 200 of 2^8."""
    ks = _full_width(seed, n + 1)
    cs = ConstraintSystem()
    out = cs.alloc_public()
    x = cs.alloc()
    acc = LC.var(x)
    for k in ks[:n]:
        acc = cs.mul(acc, LC.var(x) + LC.const(k))
    cs.enforce_zero(acc - LC.var(out))
    v = ks[n]
    for k in ks[:n]:
        v = v * (ks[n] + k) % P
    w = cs.compute_witness({out: v, x: ks[n]})
    assert cs.check(w)
    return cs, w


def _circuit(name):
    if name == "toy":
        cs, prod, total, x, y = _toy_circuit()
        w = cs.compute_witness({prod: 21, total: 10, x: 3, y: 7})
    elif name == "cubic":
        cs, out, x = _cubic_circuit()
        w = cs.compute_witness({out: (47 ** 3 + 47 + 5) % P, x: 47})
    else:
        cs, w = _chain(int(name[len("chain"):]), 11)
    assert cs.check(w)
    return cs, w


def _words_of(limbs) -> torch.Tensor:
    return limbs_to_words(to_tensor(np.asarray(limbs), "cpu"))


def _zkey_triples(seed, m, nv, nterms):
    """zkey-style (matrix, row, signal, value) triples: shuffled, with
    repeated (matrix, row, signal) entries, some rows empty."""
    rng = np.random.default_rng(seed)
    vals = _full_width(seed + 1, nterms)
    rows = rng.integers(0, m - 2, nterms)
    sigs = rng.integers(0, nv, nterms)
    mats = rng.integers(0, 2, nterms)
    out = [(int(a), int(r), int(s), v)
           for a, r, s, v in zip(mats, rows, sigs, vals)]
    out += out[:nterms // 4]                   # repeats, summed
    order = rng.permutation(len(out))
    return [out[i] for i in order]


# -- (a) the compressed-row tables ------------------------------------------------

@pytest.mark.parametrize("name", ["toy", "cubic", "chain200"])
def test_compressed_rows_match_reference(name):
    """The compressed rows of an R1CS hold each row's terms, and a plain
    walk over them (`rows_plain`, the row kernel's plain version) equals
    the reference's `eval_rows_device` limb for limb."""
    cs, w = _circuit(name)
    m = port._domain_size(cs)
    rows = port._qap_rows(cs)
    sp = port.sparse_rows(cs, "cpu")
    assert sp.names == ("A", "B", "C") and sp.num_rows == len(rows)
    rowptr = sp.rowptr.tolist()
    assert rowptr[0] == 0 and rowptr == sorted(rowptr)
    # the table holds c R^2 mod r: decoded (x R^-1) c R
    coeffs = [v * FR_CTX.r_inv % P
              for v in FR_CTX.decode(words_to_limbs(sp.coeffs))]
    for k in range(3):
        for j, triple in enumerate(rows):
            lo, hi = rowptr[k * len(rows) + j], rowptr[k * len(rows) + j + 1]
            got = sorted(zip(sp.cols[lo:hi].tolist(), coeffs[lo:hi]))
            assert got == sorted((c, v % P) for c, v in triple[k].terms.items())
    got = rowval.rows_plain(sp, rowval.ints_to_words(w, "cpu"), m)
    want = eval_rows_device(RefRows(rows, len(rows)), w, m)
    for g, r in zip(got, want):
        assert torch.equal(g, _words_of(r))


def test_zkey_triples_shuffled_with_repeats_match_reference():
    """zkey-style triples in any order, with repeated entries: the rows
    are sorted once, and the plain walk equals the reference zkey path's
    A and B rows (`_ab_rows_device`)."""
    m, nv = 32, 40
    triples = _zkey_triples(5, m, nv, 300)
    w = _full_width(6, nv)
    mats = {"A": ([], [], []), "B": ([], [], [])}
    for mat, row, sig, val in triples:
        for lst, x in zip(mats["AB"[mat]], (val, sig, row)):
            lst.append(x)
    sp = rowval.SparseRows(mats, m, "cpu")
    assert sp.nnz == len(triples)
    assert sp.longest == int(np.bincount(
        [2 * r + a for a, r, _, _ in triples]).max())
    got = rowval.rows_words(sp, rowval.ints_to_words(w, "cpu"), m)
    want = ref_zkey._ab_rows_device(
        types.SimpleNamespace(coeffs=triples, domain_size=m), w)
    for g, r in zip(got, want):
        assert torch.equal(g, _words_of(r))
    for k in range(2):                   # and python ints, row by row
        rows = [0] * m
        for mat, row, sig, val in triples:
            if mat == k:
                rows[row] = (rows[row] + val * w[sig]) % P
        assert FR_CTX.decode(words_to_limbs(got[k])) == rows


@pytest.mark.parametrize("name", ["cubic", "chain200", "long_row",
                                  "zkey_empty_padding"])
def test_r2_coefficient_table_equals_montgomery_route(name):
    """The row table's c R^2 mod r against the witness's standard-form
    words gives, term by term, the products of the old route (the witness
    and the table each encoded x R, a product by R^2): mont_mul(c R^2, w) =
    mont_mul(c R, w R) = c w R. Summed by row as the row kernel sums them,
    they equal `rows_words` from the standard-form words."""
    if name in KINDS:
        mats, num_rows, m, nv, _ = _matrices(name)
        sp = rowval.SparseRows(mats, num_rows, "cpu")
        w = _full_width(78, nv)
    else:
        cs, w = _circuit(name)
        m = port._domain_size(cs)
        sp = port.sparse_rows(cs, "cpu")
    w_std = rowval.ints_to_words(w, "cpu")
    cols = sp.cols.long()
    card = FR_CTX.mont_mul(words_to_limbs(sp.coeffs),
                           words_to_limbs(w_std)[cols])
    r2 = N.fr_const(FR_CTX.R2, "cpu", mont=False)
    old = FR_CTX.mont_mul(words_to_limbs(N.pointwise_plain(sp.coeffs_std,
                                                           k=r2)),
                          words_to_limbs(N.pointwise_plain(w_std, k=r2))[cols])
    assert torch.equal(card, old)
    vals, rowptr, nr = tensor_to_ints(card), sp.rowptr.tolist(), sp.num_rows
    sums = [0] * (sp.nmat * m)
    for g in range(sp.nmat * nr):
        sums[g // nr * m + g % nr] = sum(vals[rowptr[g]:rowptr[g + 1]]) % P
    got = rowval.rows_words(sp, w_std, m)
    assert tensor_to_ints(words_to_limbs(got)) == sums


def test_row_of_2_16_terms_refused_like_reference():
    """A row of 2^16 terms is refused, as the reference refuses it."""
    n = 1 << 16
    coeffs, cols, rids = [1] * n, list(range(n)), [0] * n
    with pytest.raises(ValueError, match="row too long"):
        rowval.SparseRows({"A": (coeffs, cols, rids)}, 1, "cpu")
    big = LC()
    big.terms = dict.fromkeys(range(n), 1)
    with pytest.raises(ValueError, match="row too long"):
        RefRows([(big, LC(), LC())], 1)
    rowval.SparseRows({"A": (coeffs[1:], cols[1:], rids[1:])}, 1, "cpu")


# -- (b) the tables the kernels read ------------------------------------------------

@pytest.mark.parametrize("logn", [1, 4, 10, 11])
def test_word_tables_match_plain_and_reference(logn):
    """Twiddles, 1/n and the coset powers as words equal `limbs_to_words`
    of the plain limb tables and the reference's `_stage_consts` /
    `_coset_consts`, on both sides of the tile boundary."""
    for invert in (False, True):
        tw, n_inv = N.word_tables(logn, invert, "cpu")
        _, tw_l, n_inv_l = N._stage_consts(logn, invert, "cpu")
        rev_r, tw_r, n_inv_r = ref_ntt._stage_consts(logn, invert)
        assert tw.shape == ((1 << logn) - 1, 8) and tw.dtype == torch.int32
        assert torch.equal(tw, limbs_to_words(tw_l))
        assert torch.equal(tw, _words_of(tw_r))
        assert torch.equal(n_inv, _words_of(n_inv_r))
        assert np.array_equal(N._bitrev(logn), rev_r)
        assert torch.equal(N.fr_const(ref_ntt.fr_inv(1 << logn), "cpu"),
                           n_inv)
        cw = N.coset_words(logn, COSET_GEN, invert, "cpu")
        assert torch.equal(cw, limbs_to_words(
            N._coset_consts(logn, COSET_GEN, invert, "cpu")))
        assert torch.equal(cw, _words_of(
            ref_ntt._coset_consts(logn, COSET_GEN, invert)))


def _source_const(name: str) -> int:
    src = (CSRC / "fr_ntt.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tile_log_matches_kernel_source():
    assert _source_const("kTileLog") == N.TILE_LOG


def test_pass_plan_matches_kernel_source():
    """PASS_LOG and the gather modes equal the source's; for every logn
    1-28 (the kernels' limit) the passes cover the stages above the tile
    once, in order, in ceil((logn - kTileLog) / kPassLog) launches of at
    most kPassLog stages, as the C entry takes them."""
    tile, most = _source_const("kTileLog"), _source_const("kPassLog")
    assert most == N.PASS_LOG
    src = (CSRC / "fr_ntt.cu").read_text()
    assert re.search(r"kGatherValue = (\d+), kGatherProduct = (\d+), "
                     r"kGatherAB = (\d+);", src).groups() == tuple(
        str(k) for k in (N.VALUE, N.PRODUCT, N.AB))
    for logn in range(1, 29):
        plan = N.pass_plan(logn)
        assert len(plan) == max(0, -(-(logn - tile) // most))
        stages = [s for s0, s1 in plan for s in range(s0, s1 + 1)]
        assert stages == list(range(tile + 1, logn + 1))
        sizes = [s1 - s0 + 1 for s0, s1 in plan]
        assert all(1 <= k <= most for k in sizes)
        assert sizes == sorted(sizes, reverse=True)
        assert not sizes or sizes[0] - sizes[-1] <= 1
    assert [len(N.pass_plan(k)) for k in (11, 12, 14, 18, 20, 28)] == \
        [0, 1, 1, 1, 2, 3]


@pytest.mark.parametrize("logn,s0,s1", [(6, 3, 5), (5, 1, 5), (8, 2, 8),
                                        (13, 12, 13)])
def test_pass_plain_equals_stage_by_stage(logn, s0, s1):
    """`ntt_pass_plain` over stages s0..s1, with both output multiplies,
    equals the DIT stages s0..s1 walked one at a time in python ints with
    the reference's twiddle table (`_stage_consts`: stage s's twiddle for
    the pair at lo is row half - 1 + (lo & (half - 1))), then the two
    products, on ranges inside and above the tile."""
    n = 1 << logn
    vals = [_full_width(40 * logn + b, n) for b in range(2)]
    x = torch.stack([_words_of(REF_FR.encode(v)) for v in vals])
    tw, _ = N.word_tables(logn, True, "cpu")
    twiddle = REF_FR.decode(ref_ntt._stage_consts(logn, True)[1])
    c, coset = 777, ref_ntt.fr_inv(COSET_GEN)
    want = []
    for v in vals:
        a = list(v)
        for s in range(s0, s1 + 1):
            half = 1 << (s - 1)
            for lo in range(n):
                if lo & half:
                    continue
                t = a[lo + half] * twiddle[half - 1 + (lo & (half - 1))] % P
                a[lo], a[lo + half] = (a[lo] + t) % P, (a[lo] - t) % P
        want.append(a)
    post = (N.fr_const(c, "cpu"), N.coset_words(logn, COSET_GEN, True, "cpu"))
    got = N.ntt_pass_plain(x, logn, s0, s1, tw)
    assert [FR_CTX.decode(words_to_limbs(g)) for g in got] == want
    want = [[v * c * pow(coset, i, P) % P for i, v in enumerate(a)]
            for a in want]
    got = N.ntt_pass_plain(x, logn, s0, s1, tw, *post)
    assert [FR_CTX.decode(words_to_limbs(g)) for g in got] == want
    if s0 > N.TILE_LOG:                       # the wrapper on the CPU
        assert torch.equal(N.ntt_pass(x, logn, s0, s1, tw, *post), got)


@pytest.mark.parametrize("logn", [1, 4, 10, 11, 12, 13, 14])
def test_ntt_words_match_reference(logn):
    """The kernels' composition (the tile, the pass launches of several
    stages from 2^13, fused input and output tables), run as plain
    versions, equals the reference's
    `ntt_device`, `intt_device`, `coset_ntt_device` and
    `coset_intt_device` on a batch of three."""
    n = 1 << logn
    enc = [REF_FR.encode(_full_width(100 * logn + b, n)) for b in range(3)]
    x = torch.stack([_words_of(e) for e in enc])
    dev = "cpu"
    n_inv = N.fr_const(ref_ntt.fr_inv(n), dev)
    cases = (
        (N.ntt_words(x, logn), ref_ntt.ntt_device),
        (N.ntt_words(x, logn, True, post_c=n_inv), ref_ntt.intt_device),
        (N.ntt_words(x, logn, pre=N.coset_words(logn, COSET_GEN, False, dev)),
         lambda a, k: ref_ntt.coset_ntt_device(a, k, COSET_GEN)),
        (N.ntt_words(x, logn, True, post_c=n_inv,
                     post_t=N.coset_words(logn, COSET_GEN, True, dev)),
         lambda a, k: ref_ntt.coset_intt_device(a, k, COSET_GEN)))
    for got, fn in cases:
        for b in range(3):
            assert torch.equal(got[b], _words_of(fn(jnp.asarray(enc[b]),
                                                    logn)))


@pytest.mark.parametrize("logn", [4, 11])
def test_limb_transforms_match_plain_limb_transforms(logn):
    """The limb API (`ntt`, `intt`, `coset_ntt`, `coset_intt`), which goes
    through the words and the kernels' plain versions on the CPU, equals
    the plain limb transforms, on a transposed view as `parallel/ntt.py`
    hands it (so the contiguity and the word conversion are exercised)."""
    n = 1 << logn
    enc = np.stack([np.asarray(REF_FR.encode(_full_width(50 * logn + b, n)))
                    for b in range(2)], axis=1)        # (n, 2, 16)
    view = to_tensor(enc, "cpu").transpose(0, 1)      # (2, n, 16), strided
    assert not view.is_contiguous()
    for invert in (False, True):
        assert torch.equal(N.ntt(view, logn, invert),
                           N.ntt_plain(view, logn, invert))
    assert torch.equal(N.intt(view, logn), N.ntt_plain(view, logn, True))
    assert torch.equal(N.coset_ntt(view, logn, COSET_GEN),
                       N.coset_ntt_plain(view, logn, COSET_GEN))
    assert torch.equal(N.coset_intt(view, logn, COSET_GEN),
                       N.coset_intt_plain(view, logn, COSET_GEN))


@pytest.mark.parametrize("logn", [4, 12])
def test_tile_product_mode_equals_pointwise_then_tile(logn):
    """The tile launch's product mode (a.b - c gathered from (B, 3, n, 8)
    words, as the H stage's coset iNTT takes it) equals `pointwise_plain`
    followed by `ntt_tile_plain`, with the output multiplies when the tile
    is the whole transform; and `ntt_words` in product mode equals the
    transform of the pointwise step, with its stage launches."""
    n = 1 << logn
    x = torch.stack([torch.stack([
        _words_of(REF_FR.encode(_full_width(30 * logn + 3 * b + k, n)))
        for k in range(3)]) for b in range(2)])       # (2, 3, n, 8)
    dev = "cpu"
    tw, _ = N.word_tables(logn, True, dev)
    post = (N.fr_const(12345, dev, mont=False),
            N.coset_words(logn, COSET_GEN, True, dev))
    last = post if logn <= N.TILE_LOG else (None, None)
    ab_c = N.pointwise_plain(x[:, 0], x[:, 1], x[:, 2])
    got = N.ntt_tile_plain(x, logn, tw, None, *last, mode=N.PRODUCT)
    assert got.shape == (2, n, 8)
    assert torch.equal(got, N.ntt_tile_plain(ab_c, logn, tw, None, *last))
    assert torch.equal(N.ntt_words(x, logn, True, None, *post,
                                   mode=N.PRODUCT),
                       N.ntt_words(ab_c, logn, True, None, *post))


@pytest.mark.parametrize("logn", [4, 12])
def test_tile_ab_mode_equals_pointwise_then_tile(logn):
    """The tile launch's AB mode (a, b and a.b from (B, 2, n, 8) words, as
    the zkey's iNTT takes its rows) equals `pointwise_plain` for a.b
    followed by `ntt_tile_plain` of the three, with the output multiplies
    when the tile is the whole transform; and `ntt_words` in AB mode
    equals the transform of a, b and a.b, with its pass launch."""
    n = 1 << logn
    x = torch.stack([torch.stack([
        _words_of(REF_FR.encode(_full_width(60 * logn + 2 * b + k, n)))
        for k in range(2)]) for b in range(2)])       # (2, 2, n, 8)
    dev = "cpu"
    tw, _ = N.word_tables(logn, True, dev)
    post = (N.fr_const(ref_ntt.fr_inv(n), dev), None)
    last = post if logn <= N.TILE_LOG else (None, None)
    abc = torch.cat([x, N.pointwise_plain(x[:, 0], x[:, 1]).unsqueeze(1)], 1)
    got = N.ntt_tile_plain(x, logn, tw, None, *last, mode=N.AB)
    assert got.shape == (2, 3, n, 8)
    assert torch.equal(got, N.ntt_tile_plain(abc, logn, tw, None, *last))
    assert torch.equal(N.ntt_words(x, logn, True, None, *post, mode=N.AB),
                       N.ntt_words(abc, logn, True, None, *post))


def test_pointwise_matches_python_ints():
    """(a.b - c) x k, the encoding (x R^2), the row table's encoding
    (`to_r2_words`, x R^3: c R^2 mod r) and the decoding (x 1 in standard
    form) against python ints."""
    a, b, c = (_full_width(s, 50) for s in (1, 2, 3))
    k = _full_width(4, 1)[0]
    mont = [_words_of(REF_FR.encode(v)) for v in (a, b, c)]
    got = N.pointwise(*mont, k=N.fr_const(k, "cpu"))
    assert FR_CTX.decode(words_to_limbs(got)) == [
        (x * y - z) * k % P for x, y, z in zip(a, b, c)]
    std = rowval.ints_to_words(a, "cpu")
    r2 = N.fr_const(FR_CTX.R2, "cpu", mont=False)
    assert torch.equal(N.pointwise(std, k=r2), mont[0])
    assert tensor_to_ints(words_to_limbs(rowval.to_r2_words(std))) == [
        (x << 512) % P for x in a]
    back = N.pointwise(mont[0], k=N.fr_const(1, "cpu", mont=False))
    assert torch.equal(back, std)


# -- (c) the whole H stage against the reference's XLA programs --------------------

@pytest.mark.parametrize("name", ["chain10", "chain200"])
def test_h_rows_match_reference_xla(name):
    """`h_rows` on the CPU (the witness converted once, then the rows and
    transforms through the kernels' plain versions) equals the
    reference's `compute_h`, which below 2^13 rows runs its compiled
    `_rows_fn` and `_h_graph`; and the plain limb pipeline
    (`h_rows_plain`) agrees."""
    cs, w = _circuit(name)
    m = port._domain_size(cs)
    assert m == {"chain10": 16, "chain200": 256}[name]
    assert ref._use_device_h(m)
    ww = rowval.ints_to_words(w, "cpu")
    h = port.h_rows(cs, ww, "cpu")
    assert h.shape == (m, 16) and not h[m - 1].any()
    want = ref.compute_h(cs, w)
    assert tensor_to_ints(h)[:m - 1] == want
    assert torch.equal(h, port.h_rows_plain(cs, w, "cpu"))


@pytest.mark.parametrize("name", ["chain10", "chain200"])
def test_odd_coset_rows_match_reference_zkey_path(name):
    """`odd_coset_rows` on the CPU equals the reference zkey path's P
    (`infimum_tpu/groth16/zkey.py:159-167`: rows, c = a.b, three iNTTs,
    three coset NTTs with generator w_2m, a.b - c), and its plain
    version agrees."""
    cs, w = _circuit(name)
    zk = port_zkey.generate_zkey(cs, random.Random(3), device="cpu")
    m = zk.domain_size
    logm = m.bit_length() - 1
    eta = port_zkey._root_of_unity(2 * m)
    a_e, b_e = ref_zkey._ab_rows_device(zk, w)
    c_e = REF_FR.mont_mul(a_e, b_e)
    ev = [ref_ntt.coset_ntt_device(ref_ntt.intt_device(v, logm), logm, eta)
          for v in (a_e, b_e, c_e)]
    want = REF_FR.decode(np.asarray(
        REF_FR.sub(REF_FR.mont_mul(ev[0], ev[1]), ev[2])))
    got = port_zkey.odd_coset_rows(zk, rowval.ints_to_words(w, "cpu"), "cpu")
    assert tensor_to_ints(got) == want
    assert torch.equal(got, port_zkey.odd_coset_rows_plain(zk, w, "cpu"))


# -- (d) kernels refuse what they do not take ---------------------------------------

@pytest.mark.parametrize("name", NEW_KERNELS)
def test_new_kernels_refuse_cpu_tensors(name):
    k = kernels.KERNELS[name]
    before = k.launches
    nptr = sum(t == kernels.ctypes.c_void_p for t in k.argtypes) - 1
    nint = len(k.argtypes) - 1 - nptr
    with pytest.raises(ValueError, match="one card"):
        k(*[torch.zeros(8, dtype=torch.int32)] * nptr, *[1] * nint)
    assert k.launches == before


def test_cpu_h_rows_never_loads_the_kernels(monkeypatch):
    """The CPU path takes the plain versions only: the library is never
    loaded and no launch is counted; a tensor on another device is
    refused."""
    def refuse():
        raise AssertionError("kernel library loaded on the CPU path")

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "library", refuse)
    kernels.reset_counts()
    cs, w = _circuit("cubic")
    port.h_rows(cs, w, "cpu")
    zk = port_zkey.generate_zkey(cs, random.Random(3), device="cpu")
    port_zkey.odd_coset_rows(zk, w, "cpu")
    assert kernels._lib is None
    assert all(kernels.launch_counts()[k] == 0 for k in NEW_KERNELS)
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no Fr kernel"):
        N.pointwise(meta)


# -- (e) on a card: each kernel against its plain version ------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("logn", [1, 4, 9, 10, 11, 12, 14, 18])
def test_ntt_kernels_match_plain_on_card(cuda_device, logn, batch):
    """Each launch against its plain version: the tile (with the input
    table, and in its PRODUCT and AB gather modes, which the H stage's
    coset iNTT and the zkey's iNTT use, B = 1 and 3), then each pass."""
    n = 1 << logn
    x = torch.stack([_words_of(REF_FR.encode(_full_width(7 * logn + b, n)))
                     for b in range(batch)]).to(cuda_device)
    abc = torch.stack([x, x.roll(1, 0), x.roll(1, 1)], 1).contiguous()
    dev = N.device_key(cuda_device)
    pre = N.coset_words(logn, COSET_GEN, False, dev)
    post_c = N.fr_const(ref_ntt.fr_inv(n), dev)
    post_t = N.coset_words(logn, COSET_GEN, True, dev)
    for invert, mode in ((False, N.VALUE), (True, N.VALUE), (True, N.PRODUCT),
                         (True, N.AB)):
        tw, _ = N.word_tables(logn, invert, dev)
        plan = N.pass_plan(logn)
        last = (None, None) if plan else (post_c, post_t)
        inp, table = {N.VALUE: (x, pre), N.PRODUCT: (abc, None),
                      N.AB: (abc[:, :2].contiguous(), None)}[mode]
        got = N.ntt_tile(inp, logn, tw, table, *last, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, N.ntt_tile_plain(inp, logn, tw, table, *last,
                                                 mode=mode))
        for s0, s1 in plan:
            post = (post_c, post_t) if s1 == logn else (None, None)
            want = N.ntt_pass_plain(got, logn, s0, s1, tw, *post)
            got = N.ntt_pass(got.clone(), logn, s0, s1, tw, *post)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        if mode != N.VALUE:
            continue
        limbs = words_to_limbs(x)
        assert torch.equal(N.ntt(limbs, logn, invert),
                           N.ntt_plain(limbs, logn, invert))
    limbs = words_to_limbs(x)
    assert torch.equal(N.coset_intt(N.coset_ntt(limbs, logn, COSET_GEN),
                                    logn, COSET_GEN), limbs)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("logn", [12, 14, 18, 20, 22])
def test_ntt_pass_matches_plain_on_card(cuda_device, logn, batch):
    """Each pass launch of `pass_plan(logn)` (one at 2^12-2^18, two at
    2^20 and 2^22) against its plain version on the tile's output, the
    last with both output multiplies; then the whole `ntt_words` (one
    tile launch and the passes) against the tile (held against its plain
    version above) and the plain passes."""
    n = 1 << logn
    rng = np.random.default_rng(logn * 10 + batch)
    w = rng.integers(0, 1 << 32, size=(batch, n, 8), dtype=np.int64)
    w[..., 7] &= 0x0FFFFFFF                            # below r
    x = torch.from_numpy(w.astype(np.int32)).to(cuda_device)
    dev = N.device_key(cuda_device)
    tw, _ = N.word_tables(logn, True, dev)
    post = (N.fr_const(ref_ntt.fr_inv(n), dev),
            N.coset_words(logn, COSET_GEN, True, dev))
    plan = N.pass_plan(logn)
    assert len(plan) == (1 if logn <= 18 else 2)
    kernels.reset_counts()
    got = N.ntt_words(x, logn, True, None, *post)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fr_ntt_pass"] == len(plan)
    want = N.ntt_tile(x, logn, tw)
    for s0, s1 in plan:
        last = post if s1 == logn else (None, None)
        step = N.ntt_pass(want.clone(), logn, s0, s1, tw, *last)
        torch.cuda.synchronize()
        want = N.ntt_pass_plain(want, logn, s0, s1, tw, *last)
        assert torch.equal(step, want)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_pointwise_kernel_matches_plain_on_card(cuda_device):
    a, b, c = (_words_of(REF_FR.encode(_full_width(s, 1000))).to(cuda_device)
               for s in (1, 2, 3))
    k = N.fr_const(12345, N.device_key(cuda_device))
    for args in ((a, b, c, k), (a, None, None, k), (a, b, None, None),
                 (a, None, c, None)):
        got = N.pointwise(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, N.pointwise_plain(*args))


@pytest.mark.cuda
def test_pointwise_kernel_sizes_on_card(cuda_device):
    """One launch a call, equal to plain bit for bit: at n = 1, 3, 255,
    2^16 - 1 and 2^16 + 1 (a.b - c x R^3, and a x table), and at the main
    path's five shapes: the key load's x R^3 over 2^18 standard-form
    values, the zkey's a.b - c x 1 over 2^18, the sharded NTT's twiddle
    product over 2^18, 2^17 and 2^16 values."""
    rng = np.random.default_rng(18)
    dev = N.device_key(cuda_device)

    def values(n):
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
        w[:, 7] %= FR_MOD >> 224                       # below r
        return torch.from_numpy(w.astype(np.int32)).to(cuda_device)
    r3 = N.fr_const(FR_CTX.R2 * FR_CTX.R, dev, mont=False)
    one = N.fr_const(1, dev, mont=False)
    cases = []
    for n in (1, 3, 255, (1 << 16) - 1, (1 << 16) + 1):
        cases += [(values(n), values(n), values(n), r3),
                  (values(n), values(n), None, None)]
    cases += [(values(1 << 18), None, None, r3),
              (values(1 << 18), values(1 << 18), values(1 << 18), one)]
    cases += [(values(n), values(n), None, None)
              for n in (1 << 18, 1 << 17, 1 << 16)]
    k = kernels.KERNELS["fr_pointwise"]
    for args in cases:
        before = k.launches
        got = N.pointwise(*args)
        torch.cuda.synchronize()
        assert k.launches == before + 1
        assert torch.equal(got, N.pointwise_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["toy", "chain200", "process_mix",
                                  "long_row", "zkey_empty_padding"])
def test_rows_and_h_kernels_match_plain_on_card(cuda_device, name):
    """The row kernel against its plain version on circuits and on the
    synthetic matrices of test_torch_rows_partition.py (rows of up to 507
    terms, a row over four warps' slices, empty and padding rows,
    shuffled zkey triples with repeats); on the circuits, the whole
    `h_rows` through every H kernel against its plain version and the
    host's h."""
    if name in KINDS:
        mats, num_rows, m, nv, _ = _matrices(name)
        sp = rowval.SparseRows(mats, num_rows, cuda_device)
        w_std = rowval.ints_to_words(_full_width(77, nv), cuda_device)
        got = rowval.rows_words(sp, w_std, m)
        torch.cuda.synchronize()
        assert torch.equal(got, rowval.rows_plain(sp, w_std, m))
        return
    cs, w = _circuit(name)
    m = port._domain_size(cs)
    sp = port.sparse_rows(cs, cuda_device)
    w_std = rowval.ints_to_words(w, cuda_device)
    got = rowval.rows_words(sp, w_std, m)
    torch.cuda.synchronize()
    assert torch.equal(got, rowval.rows_plain(sp, w_std, m))
    kernels.reset_counts()
    h = port.h_rows(cs, w, cuda_device)
    passes = len(N.pass_plan(m.bit_length() - 1))
    assert {k: kernels.launch_counts()[k] for k in NEW_KERNELS} == {
        "fr_rows": 1, "fr_ntt_tile": 3, "fr_ntt_pass": 3 * passes,
        "fr_pointwise": 0}
    assert torch.equal(h, port.h_rows_plain(cs, w, cuda_device))
    assert tensor_to_ints(h)[:m - 1] == ref.compute_h_host(cs, w)


@pytest.mark.cuda
def test_odd_coset_rows_match_plain_on_card(cuda_device):
    """The zkey path's H stage on a card: the row launch, the iNTT's tile
    gathering a, b and a.b, the coset NTT's tile and one pointwise launch
    (a.b - c), equal to its plain version and to the reference's."""
    cs, w = _circuit("chain200")
    zk = port_zkey.generate_zkey(cs, random.Random(3), device=cuda_device)
    port_zkey.zkey_rows(zk, cuda_device)
    kernels.reset_counts()
    got = port_zkey.odd_coset_rows(zk, w, cuda_device)
    torch.cuda.synchronize()
    assert {k: kernels.launch_counts()[k] for k in NEW_KERNELS} == {
        "fr_rows": 1, "fr_ntt_tile": 2, "fr_ntt_pass": 0, "fr_pointwise": 1}
    assert torch.equal(got, port_zkey.odd_coset_rows_plain(zk, w,
                                                           cuda_device))
    assert torch.equal(got.cpu(), port_zkey.odd_coset_rows(zk, w, "cpu"))
