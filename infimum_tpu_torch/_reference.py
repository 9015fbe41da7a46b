"""Entry to the reference package's pure-Python host layers without JAX.

`infimum_tpu/ff/__init__.py` imports `ff/fp.py`, and `fp.py` imports JAX, so
importing any module of `infimum_tpu` normally loads JAX. The host layers the
port reuses (`ff.bn254`, `ff.limbs`, `curve.bn254_host`, `groth16.r1cs`,
`circuits`, `witness`, `maci`, `io.arkworks`, `native`) need nothing of
`fp.py`. If `infimum_tpu.ff` is not imported yet, this module registers it as
a bare package whose `__path__` is the real directory: its submodules then
import as usual while its `__init__` never runs. Where the reference's own
`ff` package is already imported (as in the tests, which load both), this
does nothing.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types


def _register_bare_ff() -> None:
    if "infimum_tpu.ff" in sys.modules:
        return
    import infimum_tpu

    path = os.path.join(os.path.dirname(infimum_tpu.__file__), "ff")
    mod = types.ModuleType("infimum_tpu.ff")
    mod.__path__ = [path]
    mod.__spec__ = importlib.util.spec_from_loader(
        "infimum_tpu.ff", loader=None, is_package=True)
    mod.__spec__.submodule_search_locations = [path]
    sys.modules["infimum_tpu.ff"] = mod
    infimum_tpu.ff = mod


_register_bare_ff()
