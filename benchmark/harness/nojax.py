"""The check that nothing of JAX or of the JAX package was loaded: the
top-level name of every module in `sys.modules` (the part before the first
dot), compared whole, so that `infimum_tpu_torch` is not `infimum_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "infimum_tpu"})


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
