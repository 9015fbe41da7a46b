"""The harness finds every cell, configuration, traffic mix and metric of
BENCHMARK.json by name, and the file keeps the contract's names."""

import bench_paths  # noqa: F401  (sys.path for the harness)

import json
import re

import pytest

from harness import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(BENCH, name)
    config = spec.config(BENCH, cell["config"])
    mix = spec.traffic(cell["traffic"])
    assert config["name"] == cell["config"]
    assert mix["circuit"] in ("process", "tally")
    assert mix["witnesses"] >= 1
    for traced in (False, True):
        found = spec.metrics(BENCH, name, traced)
        assert found, "every cell reports end-to-end and per-layer metrics"
        for m in found:
            assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in spec.metrics(BENCH, name, False)}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_reader(metric):
    assert callable(spec.reader(metric))


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.traffic("no-such-mix")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")


def test_names_and_units():
    names = CELLS + [c["name"] for c in BENCH["configs"]]
    names += [m["name"] for m in METRICS]
    names += [c["config"] for c in BENCH["workloads"]]
    names += [c["traffic"] for c in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_configs_state_their_cuts():
    for entry in BENCH["configs"]:
        with open(spec.ROOT / entry["file"]) as f:
            config = json.load(f)
        assert config["reduced"] == entry["reduced"]
        assert config["source"] == entry["source"]
        for key in entry["reduced"]:
            assert key in config["assumed"] and key in config["published"]


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


def test_configs_pin_both_circuits():
    for entry in BENCH["configs"]:
        circuits = spec.config(BENCH, entry["name"])["circuits"]
        assert set(circuits) == {"process", "tally"}
        for shape in circuits.values():
            assert set(shape) == {"constraints", "num_vars", "num_public",
                                  "rows_sha256"}


def test_pinned_tally_circuit_is_the_programs():
    # TallyVotes(10,1,2), 12,412 constraints as published; both
    # configurations prove it (the process circuits take 12 s each to build)
    from harness.reference import circuit_shape
    from infimum_tpu_torch.circuits.tally import TallyCircuit

    shapes = [spec.config(BENCH, e["name"])["circuits"]["tally"]
              for e in BENCH["configs"]]
    config = spec.config(BENCH, BENCH["configs"][0]["name"])
    tc = TallyCircuit(state_tree_depth=config["registration_depth"],
                      int_state_tree_depth=config["tally_subtree_depth"],
                      vote_option_tree_depth=config["vote_option_tree_depth"])
    assert all(s == circuit_shape(tc.cs) for s in shapes)
    assert shapes[0]["constraints"] == 12412
