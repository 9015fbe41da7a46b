"""The check for JAX compares whole top-level names, and a run fails where
one is loaded."""

import bench_paths  # noqa: F401  (sys.path for the harness)

import sys
import types

import pytest

from harness import nojax


def test_whole_top_level_names():
    assert nojax.loaded(["infimum_tpu_torch", "infimum_tpu_torch.ntt",
                         "jaxtyping", "flaxen", "torch"]) == []
    assert nojax.loaded(["infimum_tpu.groth16", "jax._src.core",
                         "jaxlib", "flax.linen"]) == [
        "flax", "infimum_tpu", "jax", "jaxlib"]


def test_this_process_is_clean():
    import harness.cell  # noqa: F401  (imports the program)

    assert nojax.loaded() == []


def test_a_run_refuses_a_loaded_jax(monkeypatch):
    from toy import toy_cell

    from harness.runner import ForbiddenModules, measure

    dep, inputs, ref = toy_cell()
    from harness import check
    from infimum_tpu_torch.groth16.groth16 import Proof

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(ForbiddenModules, match="jax"):
        measure(dep, inputs, {}, 0.001, 1, 0.0,
                prove=check.control_prove(ref, Proof))
