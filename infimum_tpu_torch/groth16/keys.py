"""Proving keys carried over from the reference package.

Counterpart of `infimum_tpu/groth16/pkcache.py`'s reader. `from_reference`
turns a reference `ProvingKey` (in memory) into this package's, and
`load_npz` reads the reference's on-disk key cache with numpy alone: raw
little-endian 16-bit limb arrays (standard form, not Montgomery) per query,
plus infinity masks (`pkcache.py:11-13`).
"""

from __future__ import annotations

import numpy as np

from ..ff.limbs import NLIMBS, batch_from_limbs
from .groth16 import ProvingKey, VerifyingKey

FORMAT_VERSION = 1
_G1_SINGLES = ("alpha_g1", "beta_g1", "delta_g1")
_G2_SINGLES = ("beta_g2", "delta_g2", "gamma_g2")
_G1_QUERIES = ("a_query", "b_g1_query", "l_query", "h_query", "ic")
_G2_QUERIES = ("b_g2_query",)
_VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "ic")
_PK_FIELDS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
              "a_query", "b_g1_query", "b_g2_query", "l_query", "h_query")


def from_reference(pk) -> ProvingKey:
    """A reference `infimum_tpu.groth16.groth16.ProvingKey` as this
    package's `ProvingKey` (same points, copied lists)."""
    vk = VerifyingKey(**{f: _copy(getattr(pk.vk, f)) for f in _VK_FIELDS})
    return ProvingKey(vk=vk, **{f: _copy(getattr(pk, f)) for f in _PK_FIELDS})


def _copy(v):
    return list(v) if isinstance(v, list) else v


def _g1_from_arrays(limbs, inf):
    ints = batch_from_limbs(limbs.reshape(-1, NLIMBS))
    return [None if inf[i] else (ints[2 * i], ints[2 * i + 1])
            for i in range(limbs.shape[0])]


def _g2_from_arrays(limbs, inf):
    ints = batch_from_limbs(limbs.reshape(-1, NLIMBS))
    return [None if inf[i] else ((ints[4 * i], ints[4 * i + 1]),
                                 (ints[4 * i + 2], ints[4 * i + 3]))
            for i in range(limbs.shape[0])]


def load_npz(path: str) -> ProvingKey:
    """Read a key written by the reference's `pkcache.save_pk`."""
    with np.load(path) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(f"pk cache format mismatch: {path}")
        pts = {n: _g1_from_arrays(z[n], [False])[0] for n in _G1_SINGLES}
        pts.update({n: _g2_from_arrays(z[n], [False])[0]
                    for n in _G2_SINGLES})
        pts.update({n: _g1_from_arrays(z[n], z[n + "_inf"])
                    for n in _G1_QUERIES})
        pts.update({n: _g2_from_arrays(z[n], z[n + "_inf"])
                    for n in _G2_QUERIES})
    vk = VerifyingKey(**{f: pts[f] for f in _VK_FIELDS})
    return ProvingKey(vk=vk, **{f: pts[f] for f in _PK_FIELDS})
