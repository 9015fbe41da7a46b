"""The port's key cache (infimum_tpu_torch.groth16.pkcache) against the
reference's (infimum_tpu.groth16.pkcache), on the same circuits and seeds.

The fingerprint equals the reference's; a key written by either package
loads in the other into equal points, and either package's setup_cached
finds the other's file; and the cases of tests/test_pkcache.py (round
trip, a hit equal to a miss, the rng left aligned after a hit, a proof
from a loaded key, a new seed a new entry, fingerprint sensitivity) run
through both packages with equal results. All equalities are exact."""

import importlib
import random

import pytest
import torch

from infimum_tpu.groth16.r1cs import LC

from test_groth16 import _cubic_circuit, _toy_circuit
from test_torch_groth16 import _synthetic

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PK_FIELDS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
             "a_query", "b_g1_query", "b_g2_query", "l_query", "h_query")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "ic")
PACKAGES = ("infimum_tpu_torch", "infimum_tpu")


def _points(pk):
    return ([getattr(pk, f) for f in PK_FIELDS]
            + [getattr(pk.vk, f) for f in VK_FIELDS])


class _Pkg:
    """One package's setup, prove, verify and key cache, the port's on the
    CPU."""

    def __init__(self, name):
        self.g16 = importlib.import_module(f"{name}.groth16.groth16")
        self.cache = importlib.import_module(f"{name}.groth16.pkcache")
        self.port = name == "infimum_tpu_torch"

    def dev(self):
        return {"device": "cpu"} if self.port else {}

    def setup(self, cs, rng):
        return self.g16.setup(cs, rng, **self.dev())

    def setup_cached(self, cs, rng, label, cache_dir):
        return self.cache.setup_cached(cs, rng, label, cache_dir=cache_dir,
                                       **self.dev())

    def prove(self, pk, cs, w, rng):
        return self.g16.prove(pk, cs, w, rng, **self.dev())


def _toy_witness():
    cs, prod, total, x, y = _toy_circuit()
    return cs, cs.compute_witness({prod: 21, total: 10, x: 3, y: 7})


def roundtrip(pkg, d):
    cs, _ = _toy_witness()
    pk = pkg.setup(cs, random.Random(42))
    path = str(d / "pk.npz")
    pkg.cache.save_pk(pk, path)
    loaded = pkg.cache.load_pk(path)
    assert _points(loaded) == _points(pk)
    return _points(loaded)


def hit_matches_miss(pkg, d):
    cs, _ = _toy_witness()
    miss = pkg.setup_cached(cs, random.Random(42), "toy", str(d))
    hit = pkg.setup_cached(cs, random.Random(42), "toy", str(d))
    assert _points(hit) == _points(miss)
    assert _points(miss) == _points(pkg.setup(cs, random.Random(42)))
    return _points(hit)


def rng_aligned_after_hit(pkg, d):
    cs, _ = _toy_witness()
    r1 = random.Random(7)
    pkg.setup_cached(cs, r1, "toy", str(d))       # miss
    after_miss = r1.random()
    r2 = random.Random(7)
    pkg.setup_cached(cs, r2, "toy", str(d))       # hit
    assert r2.random() == after_miss
    return after_miss


def prove_from_loaded_key(pkg, d):
    cs, w = _toy_witness()
    pkg.setup_cached(cs, random.Random(42), "toy", str(d))
    pk = pkg.setup_cached(cs, random.Random(42), "toy", str(d))  # from disk
    proof = pkg.prove(pk, cs, w, random.Random(1))
    assert pkg.g16.verify(pk.vk, proof, [21, 10])
    assert not pkg.g16.verify(pk.vk, proof, [22, 10])
    return proof.a, proof.b, proof.c


def different_seed_different_entry(pkg, d):
    cs, _ = _toy_witness()
    pk_a = pkg.setup_cached(cs, random.Random(1), "toy", str(d))
    pk_b = pkg.setup_cached(cs, random.Random(2), "toy", str(d))
    assert pk_a.alpha_g1 != pk_b.alpha_g1
    return pk_a.alpha_g1, pk_b.alpha_g1, sorted(p.name for p in d.iterdir())


def fingerprint_sensitivity(pkg, d):
    cs1, cs2 = _toy_circuit()[0], _toy_circuit()[0]
    same = pkg.cache.circuit_fingerprint(cs1)
    assert same == pkg.cache.circuit_fingerprint(cs2)
    cs2.enforce_zero(LC.const(0))
    changed = pkg.cache.circuit_fingerprint(cs2)
    assert same != changed
    return same, changed


CASES = {f.__name__: f for f in (
    roundtrip, hit_matches_miss, rng_aligned_after_hit, prove_from_loaded_key,
    different_seed_different_entry, fingerprint_sensitivity)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_case_matches_reference(case, tmp_path):
    results = []
    for name in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        results.append(CASES[case](_Pkg(name), d))
    assert results[0] == results[1]


@pytest.mark.parametrize("circuit", ["toy", "cubic", "synthetic"])
def test_fingerprint_matches_reference(circuit):
    from infimum_tpu.groth16.pkcache import circuit_fingerprint as ref_fp
    from infimum_tpu_torch.groth16.pkcache import circuit_fingerprint

    def build():
        if circuit == "toy":
            return _toy_circuit()[0]
        if circuit == "cubic":
            return _cubic_circuit()[0]
        return _synthetic()[0]

    assert circuit_fingerprint(build()) == ref_fp(build())


@pytest.mark.parametrize("writer", PACKAGES)
def test_key_written_by_one_loads_in_the_other(writer, tmp_path,
                                               monkeypatch):
    """save_pk of one package, load_pk of the other: equal points; and the
    other package's setup_cached finds the file (setup is never run)."""
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    w, r = _Pkg(writer), _Pkg(reader)
    cs, _ = _toy_witness()
    pk = w.setup(cs, random.Random(42))
    path = str(tmp_path / "pk.npz")
    w.cache.save_pk(pk, path)
    assert _points(r.cache.load_pk(path)) == _points(pk)

    d = tmp_path / "cache"
    written = w.setup_cached(cs, random.Random(5), "toy", str(d))

    def no_setup(*a, **k):
        raise AssertionError("setup ran: the cache was missed")

    monkeypatch.setattr(r.cache, "setup", no_setup)
    found = r.setup_cached(cs, random.Random(5), "toy", str(d))
    assert _points(found) == _points(written)


def test_disabled_cache_runs_setup(tmp_path, monkeypatch):
    """INFIMUM_PK_CACHE=0 turns the cache off: setup runs, nothing is
    written, and the key equals the reference's setup on the same seed."""
    from infimum_tpu.groth16.groth16 import setup as ref_setup
    from infimum_tpu_torch.groth16 import pkcache

    def no_save(*a, **k):
        raise AssertionError("a key was written with the cache off")

    monkeypatch.setenv("INFIMUM_PK_CACHE", "0")
    monkeypatch.setattr(pkcache, "save_pk", no_save)
    cs, _ = _toy_witness()
    pk = pkcache.setup_cached(cs, random.Random(42), "toy", device="cpu")
    assert _points(pk) == _points(ref_setup(cs, random.Random(42)))
