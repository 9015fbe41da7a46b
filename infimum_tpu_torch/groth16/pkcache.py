# Copied from infimum_tpu/groth16/pkcache.py; the reader is groth16/keys.py's
# load_npz, setup_cached passes `device` to the port's setup and is the
# span `setup.key`.
"""On-disk proving-key cache for the (insecure, single-party) trusted setup.

The reference gets its proving keys from a one-time powersoftau ceremony +
`snarkjs groth16 setup`, persisted as `.zkey` files that every proving run
just loads. This stack's `setup()` instead recomputes ~3*n_vars + m
fixed-base scalar muls every run, so the key is persisted here after the
first computation, keyed by a circuit fingerprint + setup seed, and every
later run loads it.

Format: one `.npz` per (circuit, seed) holding raw little-endian limb arrays
(ff/limbs.py packing, NOT Montgomery form) for each query plus infinity
masks, the format, version, fingerprint, file names and default directory
(`<repo>/.pk_cache`, or INFIMUM_PK_CACHE) of `infimum_tpu`'s cache: a key
either package writes loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import random

import numpy as np

from ..ff.bn254 import FR_MOD
from ..ff.limbs import NLIMBS, batch_to_limbs
from ..utils.profiling import span
from .groth16 import ProvingKey, setup
from .keys import (
    _G1_QUERIES, _G1_SINGLES, _G2_QUERIES, _G2_SINGLES, FORMAT_VERSION,
    load_npz as load_pk,
)
from .r1cs import ConstraintSystem

__all__ = ["default_cache_dir", "circuit_fingerprint", "save_pk", "load_pk",
           "setup_cached"]


def default_cache_dir() -> str:
    return os.environ.get(
        "INFIMUM_PK_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".pk_cache"))


def circuit_fingerprint(cs: ConstraintSystem) -> str:
    """Deterministic structural hash of a constraint system.

    Covers every term: per-LC term counts feed the sha directly and every
    (row, wire, coeff) triple feeds a position-weighted checksum, so a
    coefficient or wire change anywhere in the system shifts the key (a
    sampled digest could silently reuse a stale proving key and only fail
    at proof self-verification, with no hint of the cause). Memoized per
    ConstraintSystem instance since setup_cached and callers re-fingerprint
    the same object.
    """
    cached = getattr(cs, "_fingerprint_cache", None)
    if cached is not None and cached[0] == (len(cs.constraints),
                                            cs.num_vars, cs.num_public):
        return cached[1]
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION};{cs.num_vars};{cs.num_public};"
             f"{len(cs.constraints)};".encode())
    mask = (1 << 127) - 1
    checksum = 0
    for j, row in enumerate(cs.constraints):
        for k, lc in enumerate(row):
            h.update(len(lc.terms).to_bytes(3, "little"))
            w = 3 * j + k + 1
            for i, coeff in lc.terms.items():
                checksum = (checksum + w * (i + 1) * coeff) & mask
    h.update(checksum.to_bytes(16, "little"))
    out = h.hexdigest()[:24]
    cs._fingerprint_cache = ((len(cs.constraints), cs.num_vars,
                              cs.num_public), out)
    return out


def _g1_to_arrays(points):
    flat = []
    inf = np.zeros(len(points), dtype=bool)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = True
            flat += [0, 0]
        else:
            flat += [p[0], p[1]]
    return batch_to_limbs(flat).reshape(len(points), 2, NLIMBS), inf


def _g2_to_arrays(points):
    flat = []
    inf = np.zeros(len(points), dtype=bool)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = True
            flat += [0, 0, 0, 0]
        else:
            flat += [p[0][0], p[0][1], p[1][0], p[1][1]]
    return batch_to_limbs(flat).reshape(len(points), 4, NLIMBS), inf


def save_pk(pk: ProvingKey, path: str) -> None:
    arrays: dict = {"format_version": np.int64(FORMAT_VERSION)}
    for name in _G1_SINGLES:
        arrays[name], _ = _g1_to_arrays([getattr(pk, name)])
    for name in _G2_SINGLES:
        src = pk.vk if name == "gamma_g2" else pk
        arrays[name], _ = _g2_to_arrays([getattr(src, name)])
    for name in _G1_QUERIES:
        pts = pk.vk.ic if name == "ic" else getattr(pk, name)
        arrays[name], arrays[name + "_inf"] = _g1_to_arrays(pts)
    for name in _G2_QUERIES:
        arrays[name], arrays[name + "_inf"] = _g2_to_arrays(
            getattr(pk, name))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class _Replay:
    """Replays a fixed list of randrange draws (then refuses further use)."""

    def __init__(self, draws):
        self._draws = iter(draws)

    def randrange(self, *a, **k):
        return next(self._draws)


def setup_cached(cs: ConstraintSystem, rng: random.Random,
                 label: str = "circuit", cache_dir: str | None = None,
                 device="cuda") -> ProvingKey:
    """`setup()` on `device` with an on-disk cache.

    The five trapdoor values are drawn from `rng` up front (consuming it
    identically on hit and miss, so callers sharing one rng across multiple
    setups stay aligned), hashed into the cache key, and replayed into
    `setup()` on a miss. Set INFIMUM_PK_CACHE=0 to disable. The whole
    call, hit or miss, is the span `setup.key`.
    """
    with span("setup.key"):
        cache_dir = (cache_dir if cache_dir is not None
                     else default_cache_dir())
        if cache_dir in ("0", ""):
            return setup(cs, rng, device)
        draws = [rng.randrange(1, FR_MOD) for _ in range(5)]
        seed_tag = hashlib.sha256(repr(draws).encode()).hexdigest()[:16]
        path = os.path.join(
            cache_dir, f"pk_{label}_{circuit_fingerprint(cs)}_{seed_tag}.npz")
        if os.path.exists(path):
            return load_pk(path)
        pk = setup(cs, _Replay(draws), device)
        save_pk(pk, path)
        return pk
