"""The Groth16 prover's host tail in the port's native library
(infimum_tpu_torch/native/src/prove_tail.cc) against the reference's host
curve arithmetic, and the port's refusal to run without its libraries.

The native combine of an MSM's window sums equals the reference's host
Pippenger (`msm_host_fast`) of the windows' Horner sum: on window sums
from the plain MSM pipeline, on random homogeneous windows with Z != 1,
with windows at infinity, with every window at infinity and with
coordinates not brought below q. The native assembly equals the Groth16
formulas on the reference's affine points (infimum_tpu.curve.bn254_host)
for seeded r and s, zeros included, and with sums at infinity. A toy
circuit's `prove` runs its combine and assembly spans and verifies. The
loader rebuilds a library that lacks the tail's symbols, and raises,
naming the library, where one cannot be built; then `available()` is
False, and the entry points that need a library raise its error and
answer nothing."""

import random
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from infimum_tpu.curve.bn254_host import (
    G1_GEN, G2_GEN, g1_add, g1_mul_fast, g1_neg, g2_add, g2_mul_fast,
    msm_host_fast,
)
from infimum_tpu.ff.bn254 import FQ_MOD, FR_MOD
from infimum_tpu_torch import native
from infimum_tpu_torch.curve import babyjubjub
from infimum_tpu_torch.curve.bn254_host import _fq2_mul
from infimum_tpu_torch.ff.fp import ints_to_tensor, limbs_to_words
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.hash import poseidon_host
from infimum_tpu_torch.msm import msm as M
from infimum_tpu_torch.utils import blake512, profiling

from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes

MUL = {"g1": (G1_GEN, g1_mul_fast), "g2": (G2_GEN, g2_mul_fast)}


def _points(curve, rng, n):
    gen, mul = MUL[curve]
    return [mul(gen, rng.randrange(1, FR_MOD)) for _ in range(n)]


def _fq_elt(curve, rng):
    if curve == "g1":
        return rng.randrange(1, FQ_MOD)
    return (rng.randrange(FQ_MOD), rng.randrange(1, FQ_MOD))


def _scale(curve, a, z):
    return a * z % FQ_MOD if curve == "g1" else _fq2_mul(a, z)


def _homogeneous_words(curve, wins, rng, unreduced=False):
    """(nwin, PW) words of affine points (None: infinity) as homogeneous
    projective (x z, y z, z) with a random z != 1, Montgomery form, as the
    weighted kernel writes them; infinity as (0, y, 0), y random. With
    `unreduced`, each Fq value v that fits is written as v + q."""
    zero = 0 if curve == "g1" else (0, 0)
    flat = []
    for p in wins:
        if p is None:
            x, y, z = zero, _fq_elt(curve, rng), zero
        else:
            z = _fq_elt(curve, rng)
            x, y = _scale(curve, p[0], z), _scale(curve, p[1], z)
        for c in (x, y, z):
            flat += [c] if curve == "g1" else list(c)
    mont = [v * (1 << 256) % FQ_MOD for v in flat]
    if unreduced:
        mont = [v + FQ_MOD if v + FQ_MOD < 1 << 256 else v for v in mont]
    return limbs_to_words(ints_to_tensor(mont, "cpu").reshape(len(wins), -1))


def _horner_want(curve, wins):
    """sum of 2^(c w) window w by the reference's host Pippenger."""
    c = M.SPECS[curve].c_bits
    live = [(p, 1 << (c * w)) for w, p in enumerate(wins) if p is not None]
    if not live:
        return None
    return msm_host_fast([p for p, _ in live], [s for _, s in live], curve)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_combine_of_the_plain_pipeline(curve):
    rng = random.Random(101)
    n, lanes = 48, 8
    pts = _points(curve, rng, n)
    scs = [rng.randrange(FR_MOD) for _ in range(n)]
    rows, sc = M.encode_inputs(pts, scs, lanes, curve)
    words = M.msm_rows_words(rows, sc, lanes, curve)
    want = msm_host_fast(pts, scs, curve)
    assert M.combine_window_points(words, curve) == want
    assert M.combine_window_points(M.words_to_limbs(words), curve) == want


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("at_infinity,unreduced", [
    ("none", False), ("some", False), ("all", False), ("some", True)])
def test_combine_of_random_homogeneous_windows(curve, at_infinity,
                                               unreduced):
    rng = random.Random(f"{curve}-{at_infinity}-{unreduced}")
    nwin = M.SPECS[curve].n_windows
    wins = _points(curve, rng, nwin)
    if at_infinity == "some":
        for w in (0, 3, nwin - 1):          # the top window among them
            wins[w] = None
    elif at_infinity == "all":
        wins = [None] * nwin
    words = _homogeneous_words(curve, wins, rng, unreduced)
    got = native.msm_combine(words.numpy(), curve, M.SPECS[curve].c_bits)
    assert got == _horner_want(curve, wins)
    assert (got is None) == (at_infinity == "all")


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_combine_of_equal_and_opposite_windows(curve):
    """Horner's last addition meets the sum so far, 2^c P, (a doubling)
    and its negation (infinity), and the windows -P, P."""
    rng = random.Random(7)
    c = M.SPECS[curve].c_bits
    (p,) = _points(curve, rng, 1)
    mul = MUL[curve][1]
    for wins in ([mul(p, 1 << c), p], [mul(p, FR_MOD - (1 << c)), p],
                 [mul(p, FR_MOD - 1), p]):
        words = _homogeneous_words(curve, wins, rng)
        got = native.msm_combine(words.numpy(), curve, c)
        assert got == _horner_want(curve, wins)


def test_combine_refuses_a_wrong_width():
    with pytest.raises(ValueError, match="words"):
        native.msm_combine(torch.zeros((20, 48), dtype=torch.int32).numpy(),
                           "g1", 13)


def _key(rng):
    g1 = _points("g1", rng, 3)
    g2 = _points("g2", rng, 2)
    return SimpleNamespace(alpha_g1=g1[0], beta_g1=g1[1], delta_g1=g1[2],
                           beta_g2=g2[0], delta_g2=g2[1])


def _assembly_want(key, a, b2, b1, l, h, r, s):
    """A = alpha + a + r delta, B = beta_2 + b2 + s delta_2, C = l + h + s A
    + r (beta_1 + b1 + s delta) - r s delta, on the reference's affine
    points."""
    pi_a = g1_add(g1_add(key.alpha_g1, a), g1_mul_fast(key.delta_g1, r))
    pi_b = g2_add(g2_add(key.beta_g2, b2), g2_mul_fast(key.delta_g2, s))
    b_g1 = g1_add(g1_add(key.beta_g1, b1), g1_mul_fast(key.delta_g1, s))
    pi_c = g1_add(l, h)
    pi_c = g1_add(pi_c, g1_mul_fast(pi_a, s))
    pi_c = g1_add(pi_c, g1_mul_fast(b_g1, r))
    pi_c = g1_add(pi_c, g1_neg(g1_mul_fast(key.delta_g1, r * s % FR_MOD)))
    return pi_a, pi_b, pi_c


@pytest.mark.parametrize("r,s,inf_sums", [
    (0, 0, False), (0, None, False), (None, 0, False), (None, None, False),
    (FR_MOD - 1, FR_MOD - 1, False), (None, None, True)])
def test_native_assembly_equals_the_python_assembly(r, s, inf_sums):
    rng = random.Random(202)
    key = _key(rng)
    g1 = _points("g1", rng, 4)
    b2 = _points("g2", rng, 1)[0]
    if inf_sums:                    # an MSM of zero scalars: infinity
        g1[0], g1[3], b2 = None, None, None
    r = rng.randrange(FR_MOD) if r is None else r
    s = rng.randrange(FR_MOD) if s is None else s
    sums = (g1[0], b2, g1[1], g1[2], g1[3])   # a, b2, b1, l, h
    want = _assembly_want(key, *sums, r, s)
    assert g16.assemble(key, *sums, r, s) == want
    assert native.groth16_assemble(
        g16._tail_key(key), (g1[0], g1[1], g1[2], g1[3], b2), r, s) == want


def test_native_assembly_refuses_bad_inputs():
    rng = random.Random(303)
    key = g16._tail_key(_key(rng))
    sums = (*_points("g1", rng, 4), _points("g2", rng, 1)[0])
    with pytest.raises(ValueError, match="rc=-2"):
        native.groth16_assemble(key, sums, FR_MOD, 1)
    off = (sums[0][0], (sums[0][1] + 1) % FQ_MOD)
    with pytest.raises(ValueError, match="rc=-1"):
        native.groth16_assemble(key, (off, *sums[1:]), 1, 1)


def _prove(pk, cs, w):
    t0 = time.perf_counter()
    proof = g16.prove(pk, cs, w, random.Random(43), device="cpu")
    found = {s.name: s for s in profiling.spans(t0, time.perf_counter())}
    return proof, found


@pytest.fixture(scope="module")
def toy():
    cs, w = _toy_witness()
    return g16.setup(cs, random.Random(42), device="cpu"), cs, w


def test_prove_through_the_native_tail(toy):
    pk, cs, w = toy
    proof, found = _prove(pk, cs, w)
    assert {"prove.msm_wait.combine", "prove.assembly"} <= set(found)
    assert g16.verify(pk.vk, proof, w[1:cs.num_public + 1])


def test_loader_rebuilds_a_library_without_the_tail(tmp_path):
    """A library on disk that lacks a bound symbol is rebuilt once from its
    sources."""
    src = native._VERIFY_DIR
    shutil.copytree(src / "src", tmp_path / "src")
    shutil.copy(src / "Makefile", tmp_path / "Makefile")
    lib = tmp_path / "libinfimum_verify.so"
    lib.write_bytes(b"\0inf_groth16_verify\0")     # an older library
    assert native._lacks(lib, native._VERIFY_SYMBOLS)
    opened = native._open(tmp_path, lib, native._VERIFY_SYMBOLS)
    assert not native._lacks(lib, native._VERIFY_SYMBOLS)
    assert all(hasattr(opened, name) for name in native._VERIFY_SYMBOLS)


def _unbuildable(tmp_path, which):
    """A copy of one library's sources with no Makefile: the repo-root
    library missing, or the port's library older than its tail."""
    if which == "native":
        shutil.copytree(native._NATIVE_DIR / "src", tmp_path / "src")
        return tmp_path / "libinfimum_native.so", ()
    shutil.copytree(native._VERIFY_DIR / "src", tmp_path / "src")
    lib = tmp_path / "libinfimum_verify.so"
    lib.write_bytes(b"\0inf_groth16_verify\0")
    return lib, native._VERIFY_SYMBOLS


@pytest.mark.parametrize("which", ["native", "verify"])
def test_loader_raises_where_a_library_cannot_be_built(tmp_path, which,
                                                       monkeypatch):
    lib, symbols = _unbuildable(tmp_path, which)
    with pytest.raises(RuntimeError, match=str(lib)):
        native._open(tmp_path, lib, symbols)
    dir_name, path_name = {"native": ("_NATIVE_DIR", "_LIB_PATH"),
                           "verify": ("_VERIFY_DIR", "_VERIFY_PATH")}[which]
    monkeypatch.setattr(native, dir_name, tmp_path)
    monkeypatch.setattr(native, path_name, lib)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=str(lib)):
        native._load()
    assert native.available() is False


ENTRY_POINTS = {
    "prove": lambda pk, cs, w, proof: g16.prove(
        pk, cs, w, random.Random(43), device="cpu"),
    "verify": lambda pk, cs, w, proof: g16.verify(
        pk.vk, proof, w[1:cs.num_public + 1]),
    "poseidon": lambda *_: poseidon_host.poseidon([1, 2]),
    "blake512": lambda *_: blake512.blake512(b"infimum"),
    "babyjubjub_mul": lambda *_: babyjubjub.mul(babyjubjub.BASE8, 777),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_refuse_without_the_library(toy, entry, tmp_path,
                                                 monkeypatch):
    """With the repo-root library's directory empty, each entry point
    raises the loader's error, naming the library, and returns nothing:
    no Python answer in its place."""
    pk, cs, w = toy
    proof, _ = _prove(pk, cs, w)
    monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "libinfimum_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_vlib", None)
    with pytest.raises(RuntimeError, match=str(native._LIB_PATH)):
        ENTRY_POINTS[entry](pk, cs, w, proof)
