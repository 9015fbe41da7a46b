# Copied from infimum_tpu/ff/limbs.py; the port keeps its own host layers.
"""Limb-decomposed representation of 256-bit field elements for TPU kernels.

A field element is a vector of NLIMBS=16 little-endian limbs of LIMB_BITS=16 bits,
stored in uint32 lanes. All device arithmetic keeps every intermediate strictly below
2^32 so that plain uint32 vector ops are exact on the TPU VPU:

  - products of two 16-bit limbs are < 2^32 (exact in uint32),
  - their lo/hi 16-bit halves are < 2^16,
  - column sums of <= 32 halves are < 2^21.

This is the design the whole stack layers on (SURVEY.md section 7 "Hard parts").
"""

from __future__ import annotations

import numpy as np

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """python int -> (nlimbs,) uint32 little-endian limb vector."""
    out = np.zeros((nlimbs,), dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def from_limbs(a) -> int:
    """(nlimbs,) limb vector -> python int."""
    a = np.asarray(a)
    x = 0
    for i in reversed(range(a.shape[-1])):
        x = (x << LIMB_BITS) | int(a[i])
    return x


def batch_to_limbs(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """iterable of ints -> (N, nlimbs) uint32 (via little-endian byte packing)."""
    xs = list(xs)
    nbytes = nlimbs * LIMB_BITS // 8
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return (
        np.frombuffer(buf, dtype="<u2").reshape(len(xs), nlimbs).astype(np.uint32)
    )


def batch_from_limbs(a) -> list[int]:
    """(..., nlimbs) -> list of python ints (flattened over leading dims)."""
    a = np.asarray(a)
    flat = np.ascontiguousarray(a.reshape(-1, a.shape[-1]).astype("<u2"))
    row_bytes = flat.shape[1] * 2
    buf = flat.tobytes()
    return [
        int.from_bytes(buf[i * row_bytes : (i + 1) * row_bytes], "little")
        for i in range(flat.shape[0])
    ]
