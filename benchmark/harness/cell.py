"""One cell's system under test: the deployment (its circuit and proving
key, ready on the card) and the inputs a seed gives it (a closed poll's
ready batches as witnesses), and the coordinator's per-batch step.

Set-up builds only the circuit the cell proves; the other stays
dimensions only. The proving key comes through the program's key cache
(`groth16/pkcache.py`) from the configuration's key seed, so only a
checkout's first run pays the key set-up. The program's `verify` runs on
its native library, which has to load: without it, it would fall back to a
Python pairing some hundred times slower, and the cells would measure
another verifier.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from infimum_tpu_torch import native
from infimum_tpu_torch.circuits.process import ProcessCircuit
from infimum_tpu_torch.circuits.tally import TallyCircuit
from infimum_tpu_torch.client.prover import ProverKeys
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.groth16.pkcache import setup_cached
from infimum_tpu_torch.io.arkworks import serialize_proof

from . import poll
from .spec import ROOT
from .window import ProofRecord

PK_CACHE = ROOT / ".pk_cache"


@dataclass
class Deployment:
    config: dict
    mix: dict
    keys: ProverKeys           # both circuits; the other one dimensions only
    circuit: object            # the circuit the cell proves
    pk: g16.ProvingKey
    device: str

    @property
    def cs(self):
        return self.circuit.cs


@dataclass
class Inputs:
    witnesses: list[list[int]]
    publics: list[list[int]]


def deploy(config: dict, mix: dict) -> Deployment:
    """The circuit the mix proves, built, with its proving key loaded or
    set up and cached, and the program's prewarm of that circuit alone on
    the card: kernels, hint program, a throwaway proof."""
    kind = mix["circuit"]
    if kind not in ("process", "tally"):
        raise ValueError(f"unknown circuit {kind!r}")
    if not native.available():
        raise RuntimeError("the program's native library does not load, so "
                           "its verify would not be the one measured")
    pc = ProcessCircuit(
        state_tree_depth=config["registration_depth"],
        msg_tree_depth=config["interaction_depth"],
        msg_batch_depth=config["process_subtree_depth"],
        vote_option_tree_depth=config["vote_option_tree_depth"],
        build=kind == "process")
    tc = TallyCircuit(
        state_tree_depth=config["registration_depth"],
        int_state_tree_depth=config["tally_subtree_depth"],
        vote_option_tree_depth=config["vote_option_tree_depth"],
        build=kind == "tally")
    circuit = pc if kind == "process" else tc
    pk = setup_cached(circuit.cs, random.Random(config["key_seed"]),
                      label=kind, cache_dir=str(PK_CACHE), device="cuda")
    keys = ProverKeys(pc, tc, pk if kind == "process" else None,
                      pk if kind == "tally" else None)
    keys.prewarm(verbose=False, device="cuda")
    return Deployment(config, mix, keys, circuit, pk, "cuda")


def make_inputs(dep: Deployment, seed: int) -> Inputs:
    """The first `witnesses` batches of the mix's circuit in a closed poll
    made from `seed`, with their witnesses (the program's
    `circuit.assignment`) and public inputs."""
    prover = poll.closed_poll(dep.keys, dep.config, seed)
    values = poll.batches(prover, dep.mix["circuit"], dep.mix["witnesses"])
    return Inputs([dep.circuit.assignment(v) for v in values],
                  [dep.circuit.public_inputs(v) for v in values])


def program_prove(dep: Deployment, witness: list[int], rng: random.Random):
    """The program's prover on the deployment's device."""
    return g16.prove(dep.pk, dep.cs, witness, rng=rng, device=dep.device)


def program_verify(dep: Deployment, proof, public_inputs: list[int]) -> bool:
    """The program's verify, as the coordinator self-verifies."""
    return g16.verify(dep.pk.vk, proof, public_inputs)


def coordinator_step(dep: Deployment, inputs: Inputs, prove=program_prove):
    """The per-batch step of `PollProver._prove_stream`: prove, self-verify
    with the program's `verify`, serialize. `prove(dep, witness, rng)`
    stands in for the program's prover where a check puts another there."""
    def step(rec):
        k = rec.witness
        try:
            proof = rec.proof = prove(dep, inputs.witnesses[k],
                                      random.Random(rec.seed))
            rec.proved = time.perf_counter()
            rec.stages = dict(g16.LAST_PROVE_TRACE)
            verified = program_verify(dep, proof, inputs.publics[k])
            rec.verified = time.perf_counter()
            serialize_proof(proof)
            rec.end = time.perf_counter()
            rec.ok = bool(verified)
            if not verified:
                rec.error = "self-verification failed"
        except Exception as e:  # a failed proof is counted, not fatal
            rec.error = f"{type(e).__name__}: {e}"
    return step


def warm_up(dep: Deployment, inputs: Inputs, count: int = 2) -> None:
    """Steps over the first witnesses before the window, outside it:
    allocations sized by a witness's content, the verifier's first call."""
    step = coordinator_step(dep, inputs)
    for i in range(min(count, len(inputs.witnesses))):
        rec = ProofRecord(index=-1, witness=i, seed=-1 - i,
                          start=time.perf_counter())
        step(rec)
        if not rec.ok:
            raise RuntimeError(f"warm-up proof {i} failed: {rec.error}")

