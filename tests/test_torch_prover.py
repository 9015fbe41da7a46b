"""The port's ProverKeys and PollProver (infimum_tpu_torch.client.prover)
against the reference's, on the CPU with toy circuits.

`dims_only` gives the reference's circuit dimensions and no keys; `vkeys`
the same pallet bytes; `generate` loads its keys through the key cache,
process first, so they equal the reference's setup on the same rng;
`prewarm` proves each circuit once over a zero witness, and on a card
builds the kernels and logs one entry a CUDA source from
`kernels.BUILD_INFO`; `_prove_one` and `_prove_stream` give the
reference's proof bytes on the same rng; `prove_poll_results` gives the
same batches with forked witness workers and on a thread. All equalities
are exact."""

import random
from types import SimpleNamespace

import pytest
import torch

from infimum_tpu.client import prover as ref
from infimum_tpu.groth16 import groth16 as ref_g16
from infimum_tpu.io.arkworks import fr_to_hash_bytes
from infimum_tpu_torch import kernels
from infimum_tpu_torch.client import prover as port
from infimum_tpu_torch.groth16 import groth16 as g16

from test_groth16 import _cubic_circuit
from test_torch_pkcache import _toy_witness

torch.set_num_threads(1)  # the suite runs in parallel worker processes

DIMS = dict(registration_depth=10, interaction_depth=2,
            process_subtree_depth=1, tally_subtree_depth=1,
            vote_option_tree_depth=2)
CONFIG = SimpleNamespace(registration_depth=3, interaction_depth=1,
                         process_subtree_depth=1, vote_option_tree_depth=1)


class _Toy:
    """A circuit as PollProver uses one: its cs, a witness for values and
    the public inputs."""

    def __init__(self, kind):
        if kind == "toy":
            self.cs, self.w = _toy_witness()
            self.publics = [21, 10]
        else:
            self.cs, out, x = _cubic_circuit()
            pub = 47 ** 3 + 47 + 5
            self.w = self.cs.compute_witness({out: pub, x: 47})
            self.publics = [pub]

    def assignment(self, values):
        return list(self.w)

    def public_inputs(self, values):
        return list(self.publics)


def _keys(mod, setup, rng):
    pc, tc = _Toy("toy"), _Toy("cubic")
    return mod.ProverKeys(pc, tc, setup(pc.cs, rng), setup(tc.cs, rng))


def _port_keys():
    return _keys(port, lambda cs, rng: g16.setup(cs, rng, device="cpu"),
                 random.Random(11))


def test_dims_only_matches_reference():
    got, want = port.ProverKeys.dims_only(**DIMS), \
        ref.ProverKeys.dims_only(**DIMS)
    assert (got.process_pk, got.tally_pk) == (None, None)
    for a, b in ((got.process_circuit, want.process_circuit),
                 (got.tally_circuit, want.tally_circuit)):
        assert type(a).__name__ == type(b).__name__
        assert {k: v for k, v in vars(a).items() if k != "cs"} == \
            {k: v for k, v in vars(b).items() if k != "cs"}


def test_vkeys_match_reference():
    got = _port_keys()
    want = _keys(ref, ref_g16.setup, random.Random(11))
    assert got.vkeys() == want.vkeys()


def test_generate_loads_keys_through_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("INFIMUM_PK_CACHE", str(tmp_path))
    circuits = (_Toy("toy"), _Toy("cubic"))
    monkeypatch.setattr(port.ProverKeys, "circuits",
                        staticmethod(lambda *a, **k: circuits))
    keys = port.ProverKeys.generate(**DIMS, rng=random.Random(3),
                                    device="cpu")
    rng = random.Random(3)
    for pk, c in ((keys.process_pk, circuits[0]),
                  (keys.tally_pk, circuits[1])):
        assert vars(pk.vk) == vars(ref_g16.setup(c.cs, rng).vk)
    names = sorted(p.name.split("_")[1] for p in tmp_path.iterdir())
    assert names == ["process", "tally"]


def test_prewarm_on_the_cpu():
    keys = _port_keys()
    out = keys.prewarm(verbose=False, device="cpu")
    assert set(out) == {"prewarm_s", "kernel_load_log"}
    assert out["kernel_load_log"] == []
    assert list(g16.LAST_PROVE_TRACE) == ["h_dispatch", "witness_limbs",
                                          "msm_dispatch", "msm_wait"]


def test_prewarm_on_a_card_logs_each_source(monkeypatch):
    """The card's branch with its kernels and prove stood in: the kernels
    are built first, each source logged as built or cached, and one zero
    witness proved per circuit on the card."""
    keys = _port_keys()
    calls = []
    monkeypatch.setattr(kernels, "library", lambda: calls.append("library"))
    monkeypatch.setattr(kernels, "BUILD_INFO", {"sources": {
        "msm_accum.cu": 3.14159, "msm_weighted.cu": None,
        "poseidon_perm.cu": 18.0}})
    monkeypatch.setattr(port, "prove", lambda pk, cs, w, rng, device: calls.append(
        (pk is keys.process_pk or pk is keys.tally_pk, any(w),
         len(w) == cs.num_vars, device)))
    out = keys.prewarm(verbose=False, device="cuda")
    assert out["kernel_load_log"] == [
        {"kernel": "msm_accum.cu", "path": "built", "s": 3.142},
        {"kernel": "msm_weighted.cu", "path": "cached", "s": 0.0},
        {"kernel": "poseidon_perm.cu", "path": "built", "s": 18.0}]
    assert calls == ["library"] + [(True, False, True, "cuda")] * 2


@pytest.mark.parametrize("which", ["one", "stream"])
def test_prove_methods_match_reference(which, monkeypatch):
    monkeypatch.setenv("INFIMUM_HOST_H_THRESHOLD", "0")
    out = []
    for mod, keys in ((port, _port_keys()),
                      (ref, _keys(ref, ref_g16.setup, random.Random(11)))):
        kw = {"device": "cpu"} if mod is port else {}
        pp = mod.PollProver(keys, None, CONFIG, poll_end_timestamp=25,
                            rng=random.Random(5), **kw)
        jobs = [(keys.process_circuit, keys.process_pk, None,
                 {"new_commitment": 123}),
                (keys.tally_circuit, keys.tally_pk, None,
                 {"new_commitment": 456})]
        if which == "one":
            out.append([pp._prove_one(c, pk, v) for c, pk, v, _ in jobs])
        else:
            ws = iter([c.assignment(None) for c, *_ in jobs])
            out.append(pp._prove_stream(jobs, lambda: next(ws)))
    assert out[0] == out[1]
    if which == "stream":
        assert [c for _, c in out[0]] == [fr_to_hash_bytes(123),
                                          fr_to_hash_bytes(456)]


def test_prove_poll_results_workers_match_thread(monkeypatch):
    """prove_poll_results with forked witness workers
    (INFIMUM_PARALLEL_WITNESS=1) and on the thread (the default, and =0)
    gives the same batches on the same rng; the workers' path streams each
    circuit's batches through iter_assignments once, the thread's never."""
    from infimum_tpu_torch.witness import parallel

    keys, calls = _port_keys(), []
    real = parallel.iter_assignments

    def recording(circuit, batch_values, processes=None):
        calls.append(len(batch_values))
        return real(circuit, batch_values, processes)

    monkeypatch.setattr(parallel, "iter_assignments", recording)
    monkeypatch.setattr(port.os, "cpu_count", lambda: 2)
    out = {}
    for mode in ("1", "0", None):
        if mode is None:
            monkeypatch.delenv("INFIMUM_PARALLEL_WITNESS", raising=False)
        else:
            monkeypatch.setenv("INFIMUM_PARALLEL_WITNESS", mode)
        pp = port.PollProver(keys, None, CONFIG, poll_end_timestamp=25,
                             rng=random.Random(5), device="cpu")
        pp.get_poll_results = lambda: (
            [(None, {"new_commitment": 1}), (None, {"new_commitment": 2})],
            [(None, {"new_commitment": 3})], None)
        pp._outcome = lambda tb: "outcome"
        fell = parallel.FALLBACK_BATCHES
        out[mode] = (pp.prove_poll_results(), list(calls))
        assert parallel.FALLBACK_BATCHES == fell
        calls.clear()
    assert out["1"][0] == out["0"][0] == out[None][0]
    assert [c for _, c in out["1"][0][0]] == [fr_to_hash_bytes(i)
                                              for i in (1, 2, 3)]
    assert out["1"][1] == [2, 1] and out["0"][1] == out[None][1] == []
