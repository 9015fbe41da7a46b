"""The port's span log and stage trace (infimum_tpu_torch.utils.profiling,
prove()'s LAST_PROVE_TRACE) against the reference's Stopwatch.

Nested stages timed by one scripted clock give the reference's `as_dict`
and stages; the log keeps parents, depths and proof ids, drops its oldest
spans past its bound and says so, and filters by interval; a prove() on
the CPU records the reference's four stage names and, as spans, exactly
the prover's stages nested in `prove`; the native verify's three phases
nest in `verify` on the same clock; set-up records its three spans;
`_prove_stream` gives each batch's spans its id; INFIMUM_TRACE prints the
last proof's spans, or a proof scope's all together; trace() writes a
Chrome trace with the spans only under INFIMUM_PROFILE_DIR, on its
events' clock, and without its clock markers."""

import json
import random
import re
import time
from collections import deque

import pytest
import torch

from infimum_tpu.utils import profiling as ref
from infimum_tpu_torch import native
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.utils import profiling as port

from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes

STAGES = ["h_dispatch", "witness_limbs", "msm_dispatch", "msm_wait"]
# the prover's spans, each after its parent, in the order they start
PROVE_SPANS = [
    ("prove", None), ("prove.h_dispatch", "prove"),
    ("prove.h_dispatch.words", "prove.h_dispatch"),
    ("prove.witness_limbs", "prove"), ("prove.msm_dispatch", "prove"),
    ("prove.msm_wait", "prove"),
    ("prove.msm_wait.card", "prove.msm_wait"),
    ("prove.msm_wait.combine", "prove.msm_wait"),
    ("prove.assembly", "prove")]
VERIFY_SPANS = ["verify", "verify.encode", "verify.checks", "verify.product",
                "verify.final_exp"]
# clock readings: each stage reads the clock on entry and on exit
TICKS = [0.0, 0.25, 1.0, 1.5, 3.75, 4.0, 9.125, 10.0, 12.5, 20.0]


def _nested(sw):
    with sw.stage("prove"):
        with sw.stage("h"):
            with sw.stage("ntt"):
                pass
        with sw.stage("msm"):
            pass
    with sw.stage("verify"):
        pass
    return sw


@pytest.mark.parametrize("prefix", ["", "process_"])
def test_stopwatch_matches_reference(prefix, monkeypatch):
    out = []
    for mod in (port, ref):
        clock = iter(TICKS)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        sw = _nested(mod.Stopwatch())
        d = ({prefix + k: v for k, v in sw.as_dict().items()}
             if mod is port else sw.as_dict(prefix))
        out.append((d, [(s.name, s.seconds, s.depth) for s in sw.stages]))
    assert out[0] == out[1]
    assert list(out[0][0]) == [prefix + "prove", prefix + "verify"]


def _tree(found):
    """(name, parent's name) of each span, in the order they started."""
    by_id = {s.id: s for s in found}
    return [(s.name, by_id[s.parent].name if s.parent in by_id else None)
            for s in sorted(found, key=lambda s: (s.start, s.depth))]


def test_stopwatch_stages_are_spans_under_the_caller():
    with port.span("outer") as outer:
        sw = _nested(port.Stopwatch("run"))
    tree = port.subtree(outer)
    assert _tree(tree) == [("outer", None), ("run.prove", "outer"),
                           ("run.prove.h", "run.prove"),
                           ("run.prove.h.ntt", "run.prove.h"),
                           ("run.prove.msm", "run.prove"),
                           ("run.verify", "outer")]
    # each stage's seconds are its span's, in the order they ended
    ended = sorted(tree[1:], key=lambda s: s.end)
    assert [(st.name, st.seconds) for st in sw.stages] == [
        (s.name.rsplit(".", 1)[1], s.end - s.start) for s in ended]
    assert list(sw.as_dict()) == ["prove", "verify"]


def test_span_parents_depths_and_order():
    with port.span("a") as a:
        with port.span("b") as b:
            with port.span("c") as c:
                pass
        with port.span("d") as d:
            pass
    assert (a.parent, b.parent, c.parent, d.parent) == (
        a.parent, a.id, b.id, a.id)
    assert (b.depth - a.depth, c.depth - a.depth, d.depth - a.depth) == (
        1, 2, 1)
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start \
        <= d.end <= a.end
    assert [s.name for s in port.spans(a.start, a.end)] == [
        "c", "b", "d", "a"]


def test_span_ends_on_an_exception():
    with pytest.raises(ValueError):
        with port.span("fails") as sp:
            raise ValueError("x")
    assert sp.end >= sp.start > 0
    assert port.spans(sp.start, sp.end)[-1] is sp
    with port.span("after") as after:
        pass
    assert after.parent == sp.parent   # the failed span is closed


def test_proof_scope_ids():
    with port.proof_scope(("process", 3)):
        with port.span("p") as p:
            with port.proof_scope(("tally", 0)):
                inner = port.record("inner", p.start, p.start)
            q = port.record("q", p.start, p.start)
    with port.span("none") as none:
        pass
    assert (p.proof, inner.proof, q.proof, none.proof) == (
        ("process", 3), ("tally", 0), ("process", 3), None)
    assert inner.parent == q.parent == p.id


def test_record_under_the_open_span():
    with port.span("outer") as outer:
        t = time.perf_counter()
        rec = port.record("timed.elsewhere", t - 1e-3, t)
    assert (rec.parent, rec.depth) == (outer.id, outer.depth + 1)
    assert (rec.start, rec.end) == (t - 1e-3, t)


def test_spans_filters_by_interval():
    with port.span("first") as first:
        pass
    with port.span("second") as second:
        pass
    with port.span("third") as third:
        pass
    assert [s.name for s in port.spans(second.start, second.end)] == [
        "second"]
    assert [s.name for s in port.spans(first.start, third.end)] == [
        "first", "second", "third"]
    assert [s.name for s in port.spans(first.start, second.end)] == [
        "first", "second"]
    assert [s.name for s in port.spans(first.end, third.end)] == [
        "second", "third"]
    assert port.spans(third.end + 1.0, third.end + 2.0) == []


def test_ring_bound_and_overflow(monkeypatch):
    monkeypatch.setattr(port, "RING", 4)
    monkeypatch.setattr(port, "_LOG", deque(maxlen=4))
    monkeypatch.setattr(port, "_lost_end", None)
    made = []
    for i in range(6):
        with port.span(f"s{i}") as sp:
            pass
        made.append(sp)
    assert [s.name for s in port._LOG] == ["s2", "s3", "s4", "s5"]
    # s0 and s1 were dropped: an interval that may have held them is
    # refused, one after them is whole
    assert port.spans() is None
    assert port.spans(made[1].start, made[5].end) is None
    assert port.spans(made[1].end) is None
    assert [s.name for s in port.spans(made[2].start)] == [
        "s2", "s3", "s4", "s5"]


def test_span_counters_are_kept_printed_and_returned():
    with port.span("outer", rows=3) as outer:
        port.count(terms=5, rows=4)
        with port.span("inner") as inner:
            pass
    assert outer.counts == {"rows": 4, "terms": 5}
    assert inner.counts is None     # count() reached the innermost open span
    found = port.spans(outer.start, outer.end)
    assert [(s.name, s.counts) for s in found] == [
        ("inner", None), ("outer", {"rows": 4, "terms": 5})]
    line = port.format_spans([outer])
    assert line.startswith("outer: ") and line.endswith(" ms rows=4 terms=5")


def test_span_without_counters_is_unchanged():
    with port.span("plain") as sp:
        pass
    port.count(rows=1)       # no span open: nothing to count on
    assert sp.counts is None
    assert port.format_spans([sp]) == (
        f"plain: {(sp.end - sp.start) * 1e3:.3f} ms")
    rec = port.record("timed", sp.start, sp.end)
    assert rec.counts is None


def test_stopwatch_stage_carries_counters():
    with port.span("outer") as outer:
        sw = port.Stopwatch("run")
        with sw.stage("msm", a=7, h=8):
            pass
    (stage,) = [s for s in port.subtree(outer) if s.name == "run.msm"]
    assert stage.counts == {"a": 7, "h": 8}


def _toy_prove():
    cs, w = _toy_witness()
    pk = g16.setup(cs, random.Random(42), device="cpu")
    g16.prove(pk, cs, w, random.Random(43), device="cpu")   # warm
    t0 = time.perf_counter()
    proof = g16.prove(pk, cs, w, random.Random(43), device="cpu")
    return pk, cs, w, proof, port.spans(t0, time.perf_counter())


@pytest.fixture(scope="module")
def toy_prove():
    pk, cs, w, proof, found = _toy_prove()
    return dict(pk=pk, cs=cs, w=w, proof=proof, spans=found,
                trace=dict(g16.LAST_PROVE_TRACE))


def test_prove_records_exactly_the_prover_spans(toy_prove):
    found = toy_prove["spans"]
    assert _tree(found) == PROVE_SPANS
    whole = next(s for s in found if s.name == "prove")
    assert all(whole.start <= s.start <= s.end <= whole.end for s in found)
    # the stages follow one another
    top = sorted((s for s in found if s.parent == whole.id),
                 key=lambda s: s.start)
    assert [s.name for s in top] == [
        "prove." + n for n in STAGES + ["assembly"]]
    assert all(a.end <= b.start for a, b in zip(top, top[1:]))


def test_prove_counts_the_h_stage_and_query_rows(toy_prove):
    pk, cs = toy_prove["pk"], toy_prove["cs"]
    by_name = {s.name: s for s in toy_prove["spans"]}
    assert by_name["prove.h_dispatch"].counts == {
        "domain": g16._domain_size(cs),
        "terms": g16.sparse_rows(cs, "cpu").nnz}
    assert by_name["prove.msm_dispatch"].counts == {
        "a": len(pk.a_query), "b1": len(pk.b_g1_query),
        "b2": len(pk.b_g2_query), "l": len(pk.l_query),
        "h": len(pk.h_query)}
    assert all(s.counts is None for s in toy_prove["spans"]
               if s.name not in ("prove.h_dispatch", "prove.msm_dispatch"))


def test_last_prove_trace_keeps_keys_order_and_rounding(toy_prove):
    trace, found = toy_prove["trace"], toy_prove["spans"]
    assert list(trace) == STAGES
    by_name = {s.name: s for s in found}
    for name, value in trace.items():
        sp = by_name["prove." + name]
        assert isinstance(value, float) and value == round(value, 3)
        assert abs((sp.end - sp.start) - value) <= 0.0005


def test_prove_records_the_reference_stages(monkeypatch, capsys):
    cs, w = _toy_witness()
    pk = g16.setup(cs, random.Random(42), device="cpu")
    monkeypatch.setenv("INFIMUM_TRACE", "1")
    g16.prove(pk, cs, w, random.Random(43), device="cpu")
    trace = g16.LAST_PROVE_TRACE
    assert list(trace) == STAGES
    assert all(isinstance(v, float) and v >= 0 for v in trace.values())
    err = capsys.readouterr().err.splitlines()
    names = [n for n, _ in PROVE_SPANS]
    assert [line.split(":")[0].strip() for line in err] == names
    assert [(len(line) - len(line.lstrip())) // 2 for line in err] == [
        n.count(".") for n in names]
    # each line: its milliseconds, then its counters (h_dispatch and
    # msm_dispatch carry them) as name=value
    counted = {}
    for line in err:
        ms, sep, counters = line.split(": ")[1].partition(" ms")
        assert sep and float(ms) >= 0
        assert all(re.fullmatch(r"\w+=\d+", c) for c in counters.split())
        counted[line.split(":")[0].strip()] = counters.split()
    assert [n for n, c in counted.items() if c] == [
        "prove.h_dispatch", "prove.msm_dispatch"]


def test_native_verify_phases_nest_in_order(toy_prove):
    t0 = time.perf_counter()
    assert g16.verify(toy_prove["pk"].vk, toy_prove["proof"],
                      toy_prove["w"][1:toy_prove["cs"].num_public + 1])
    found = port.spans(t0, time.perf_counter())
    assert _tree(found) == [("verify", None)] + [
        (n, "verify") for n in VERIFY_SPANS[1:]]
    whole = found[-1]
    phases = sorted(found[:-1], key=lambda s: s.start)
    assert all(whole.start <= s.start <= s.end <= whole.end for s in phases)
    assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))
    assert all(s.end > s.start for s in phases)


def test_malformed_verify_records_only_the_checks(toy_prove):
    bad = g16.Proof(a=(1, 3), b=toy_prove["proof"].b, c=toy_prove["proof"].c)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="malformed"):
        g16.verify(toy_prove["pk"].vk, bad,
                   toy_prove["w"][1:toy_prove["cs"].num_public + 1])
    found = port.spans(t0, time.perf_counter())
    assert _tree(found) == [("verify", None), ("verify.encode", "verify"),
                            ("verify.checks", "verify")]


def test_verify_records_no_phases_of_an_earlier_call(toy_prove,
                                                     monkeypatch):
    """A verify that fails before the native call records no phases: the
    library's last phases are an earlier call's."""
    publics = toy_prove["w"][1:toy_prove["cs"].num_public + 1]
    assert g16.verify(toy_prove["pk"].vk, toy_prove["proof"], publics)

    def fails(*a):
        raise RuntimeError("before the call")

    monkeypatch.setattr(native, "groth16_verify", fails)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        g16.verify(toy_prove["pk"].vk, toy_prove["proof"], publics)
    found = port.spans(t0, time.perf_counter())
    assert _tree(found) == [("verify", None), ("verify.encode", "verify")]


def test_prove_stream_gives_each_batch_its_id(monkeypatch):
    from test_torch_prover import CONFIG, _port_keys
    from infimum_tpu_torch.client import prover

    keys = _port_keys()
    pp = prover.PollProver(keys, None, CONFIG, poll_end_timestamp=25,
                           rng=random.Random(5), device="cpu")
    jobs = [(keys.process_circuit, keys.process_pk, None,
             {"new_commitment": 1}),
            (keys.tally_circuit, keys.tally_pk, None, {"new_commitment": 2}),
            (keys.process_circuit, keys.process_pk, None,
             {"new_commitment": 3})]
    ws = iter([c.assignment(None) for c, *_ in jobs])
    t0 = time.perf_counter()
    pp._prove_stream(jobs, lambda: next(ws))
    found = port.spans(t0, time.perf_counter())
    ids = [("process", 0), ("tally", 0), ("process", 1)]
    tops = sorted((s for s in found if s.name in (
        "poll.witness_wait", "prove", "verify", "poll.serialize")),
        key=lambda s: s.start)
    assert [(s.name, s.proof) for s in tops] == [
        (n, i) for i in ids
        for n in ("poll.witness_wait", "prove", "verify", "poll.serialize")]
    # every span of a batch, its prover's and verifier's too, carries its id
    assert {s.proof for s in found} == set(ids)
    for i in ids:
        names = {s.name for s in found if s.proof == i}
        assert names >= {n for n, _ in PROVE_SPANS} | set(VERIFY_SPANS)


def test_proof_scope_prints_its_spans_under_trace(monkeypatch, capsys):
    monkeypatch.delenv("INFIMUM_TRACE", raising=False)
    with port.proof_scope(("tally", 2)):
        with port.span("quiet"):
            pass
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("INFIMUM_TRACE", "1")
    with port.span("outside"):
        pass
    with port.proof_scope(("tally", 2)):
        with port.span("poll.witness_wait"):
            pass
        with port.span("prove"):
            with port.span("prove.x"):
                pass
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "proof ('tally', 2):"
    assert [line.split(":")[0] for line in err[1:]] == [
        "poll.witness_wait", "prove", "  prove.x"]
    assert all(line.endswith(" ms") for line in err[1:])


def test_prove_in_a_proof_scope_prints_once(toy_prove, monkeypatch, capsys):
    """Inside a proof scope prove() leaves its print to the scope, which
    prints the prover's and the verifier's spans together."""
    monkeypatch.setenv("INFIMUM_TRACE", "1")
    capsys.readouterr()
    with port.proof_scope(("process", 0)):
        proof = g16.prove(toy_prove["pk"], toy_prove["cs"], toy_prove["w"],
                          random.Random(44), device="cpu")
        g16.verify(toy_prove["pk"].vk, proof, [21, 10])
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "proof ('process', 0):"
    names = [line.split(":")[0].strip() for line in err[1:]]
    assert names == [n for n, _ in PROVE_SPANS] + VERIFY_SPANS


def _setup_circuit(tmp_path):
    from infimum_tpu_torch.circuits.tally import TallyCircuit

    TallyCircuit(state_tree_depth=2, int_state_tree_depth=1,
                 vote_option_tree_depth=1)


def _setup_key(tmp_path):
    from infimum_tpu_torch.groth16.pkcache import setup_cached

    cs, _ = _toy_witness()
    for _ in range(2):   # a miss, then a hit
        setup_cached(cs, random.Random(3), label="toy",
                     cache_dir=str(tmp_path), device="cpu")


def _setup_prewarm(tmp_path):
    from test_torch_prover import _port_keys

    out = _port_keys().prewarm(verbose=False, device="cpu")
    return out["prewarm_s"]


@pytest.mark.parametrize("name, run, count", [
    ("setup.circuit", _setup_circuit, 1),
    ("setup.key", _setup_key, 2),
    ("setup.prewarm", _setup_prewarm, 1)])
def test_setup_records_its_span(name, run, count, tmp_path):
    t0 = time.perf_counter()
    value = run(tmp_path)
    found = [s for s in port.spans(t0, time.perf_counter())
             if s.name.startswith("setup.")]
    assert [s.name for s in found] == [name] * count
    if name == "setup.prewarm":
        # prewarm_s is the span's seconds, and its two proofs lie in it
        assert value == round(found[0].end - found[0].start, 3)
        proves = [s for s in port.spans(t0, time.perf_counter())
                  if s.name == "prove"]
        assert len(proves) == 2 and all(s.parent == found[0].id
                                        for s in proves)


def test_trace_writes_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("INFIMUM_PROFILE_DIR", str(tmp_path))
    with port.trace("step"):
        torch.ones(4).sum()
    events = json.loads((tmp_path / "step.json").read_text())["traceEvents"]
    assert events


def test_trace_writes_the_spans_on_the_trace_clock(tmp_path, monkeypatch):
    """The block's spans go into the Chrome trace on its events' clock:
    each span's torch ops lie inside it there."""
    monkeypatch.setenv("INFIMUM_PROFILE_DIR", str(tmp_path))
    with port.span("before"):
        pass
    with port.trace("spans"):
        with port.span("outer"):
            with port.span("inner"):
                torch.ones(64).cumsum(0)
                time.sleep(0.002)
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"outer", "inner"}
    outer, inner = mine["outer"], mine["inner"]
    assert outer["ts"] <= inner["ts"] and (
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])
    assert inner["args"]["parent"] == outer["args"]["id"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name") == "aten::cumsum"]
    assert ops
    slack = 200.0   # us: the profiler's own stamps around the tie
    for op in ops:
        assert inner["ts"] - slack <= op["ts"]
        assert op["ts"] + op["dur"] <= inner["ts"] + inner["dur"] + slack


def test_trace_writes_span_counters(tmp_path, monkeypatch):
    monkeypatch.setenv("INFIMUM_PROFILE_DIR", str(tmp_path))
    with port.trace("counts"):
        with port.span("counted", rows=12):
            torch.ones(8).cumsum(0)
    events = json.loads((tmp_path / "counts.json").read_text())["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "program_span"]
    assert mine["name"] == "counted" and mine["args"]["rows"] == 12


def test_trace_takes_its_markers_out(tmp_path, monkeypatch):
    """The clock tie's markers are not left in the file: it holds the
    block's own work."""
    monkeypatch.setenv("INFIMUM_PROFILE_DIR", str(tmp_path))
    with port.trace("marks"):
        with port.span("work"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "marks.json").read_text())["traceEvents"]
    assert not [e for e in events if e.get("name") == port.MARK]
    assert [e["name"] for e in events
            if e.get("cat") == "program_span"] == ["work"]


def test_trace_off_without_profile_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("INFIMUM_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with port.trace("step"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
