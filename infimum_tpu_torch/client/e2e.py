"""Reference-dims end-to-end poll on the port, with per-phase timings.

Counterpart of `infimum_tpu/client/e2e.py` `run_reference_e2e`, step for
step: the same instantiation (ProcessMessages(10,2,1,2), domain 2^18, and
TallyVotes(10,1,2), domain 2^14), the same roles, votes and seeds. Circuit
build -> keys from the key cache (setup on the card on a miss) -> prewarm
-> poll lifecycle through the port's pallet (`InfimumPallet`) and user
roles -> witness -> Groth16 prove on the card -> self-verify (native
pairing) -> `commit_outcome`, which verifies every proof against the
pallet's own public inputs and the outcome (option 5).
"""

from __future__ import annotations

import contextlib
import random
import sys
import time
from dataclasses import dataclass

from ..groth16 import groth16 as g16
from ..groth16.pkcache import setup_cached
from ..io.arkworks import fr_to_hash_bytes, serialize_proof
from ..pallet import InfimumPallet
from .prover import PollProver, ProverKeys
from .user import Coordinator, Participant

REFERENCE_CONFIG = dict(registration_depth=10, interaction_depth=2,
                        process_subtree_depth=1, tally_subtree_depth=1,
                        vote_option_tree_depth=2)
SIGNUP, VOTING = 12, 12
PARTICIPANTS = (("bob", 0xB0B), ("charlie", 0xC0C), ("dave", 0xD0D),
                ("erin", 0xE417), ("frank", 0xF7A4))
COORDINATOR_SK = 0xA11CE


@dataclass
class E2ERun:
    timings: dict
    keys: ProverKeys
    pallet: InfimumPallet
    coordinator: Coordinator
    first_process: dict     # values, witness, proof, publics of batch 0


def poll_prover(keys: ProverKeys, pallet: InfimumPallet,
                coordinator: Coordinator, device) -> PollProver:
    """The e2e's PollProver (seed 7) with the pallet's events of poll 0
    replayed into it; a fresh one replays the same poll again."""
    poll = pallet.polls[0]
    prover = PollProver(keys, coordinator.keypair, poll.config,
                        poll_end_timestamp=poll.voting_period_end(),
                        rng=random.Random(7), device=device)
    prover.ingest_events(pallet.events, 0)
    return prover


def _clock(timings: dict, verbose: bool):
    """A context-manager factory: `with clock(name):` records the block's
    seconds in timings[name]."""
    @contextlib.contextmanager
    def stage(name: str):
        t0 = time.perf_counter()
        yield
        timings[name] = round(time.perf_counter() - t0, 3)
        if verbose:
            print(f"[{name}] {timings[name]}s", file=sys.stderr, flush=True)
    return stage


def proof_latency(timings: dict) -> float:
    """Seconds of the witness and prove stages, as the reference sums
    `proof_latency_s` (`infimum_tpu/client/e2e.py`): the witness inputs,
    each batch's witness and prove, not its self-verify."""
    return round(sum(
        v for k, v in timings.items()
        if isinstance(v, float) and k.startswith(
            ("witness_process", "witness_tally", "prove_", "witness_inputs"))
    ), 3)


def run_reference_e2e(config: dict | None = None, verbose: bool = False,
                      seed: int = 99, device="cuda") -> E2ERun:
    """The whole poll at (default) reference dims on `device`. Besides the
    phase timings, `timings` holds `trace_process` / `trace_tally` (the
    last process / tally prove()'s stages), `prewarm` and
    `kernel_load_log`, and `proof_latency_s` (witness + prove over all
    batches, without setup or self-verify). Raises on any failure."""
    config = dict(REFERENCE_CONFIG if config is None else config)
    timings: dict = {}
    clock = _clock(timings, verbose)

    with clock("build_circuits"):
        pc, tc = ProverKeys.circuits(**config)
    timings["process_constraints"] = len(pc.cs.constraints)
    timings["tally_constraints"] = len(tc.cs.constraints)

    # keys keyed by circuit fingerprint + trapdoor seed: computed on the
    # first run, loaded on every later one
    rng = random.Random(seed)
    with clock("setup_process"):
        process_pk = setup_cached(pc.cs, rng, label="process", device=device)
    with clock("setup_tally"):
        tally_pk = setup_cached(tc.cs, rng, label="tally", device=device)
    keys = ProverKeys(pc, tc, process_pk, tally_pk)

    # kernels and every proving shape readied up front, so batch 0
    # measures proving, not startup
    with clock("prewarm"):
        warm = keys.prewarm(verbose=verbose, device=device)
    timings["kernel_load_log"] = warm["kernel_load_log"]

    with clock("lifecycle"):
        pallet = InfimumPallet()
        coordinator = Coordinator("alice", sk=COORDINATOR_SK, keys=keys)
        participants = [Participant(n, sk) for n, sk in PARTICIPANTS]
        coordinator.register(pallet)
        coordinator.create_poll(pallet, SIGNUP, VOTING)
        pallet.run_to_block(2)
        for p in participants:
            p.register(pallet, 0)
        pallet.run_to_block(14)
        coordinator.merge_poll_state(pallet)
        # 11 interactions -> three process batches, five registrations ->
        # three tally batches. Messages are processed in reverse publish
        # order, so only the last-published vote is valid (nonce 1); the
        # duplicates are in-circuit no-ops and the outcome stays option 5.
        for i in range(11):
            participants[0].vote(pallet, 0, coordinator.public_key,
                                 state_index=1, vote_option=5, weight=1,
                                 nonce=1, salt=1000 + i)
        pallet.run_to_block(26)
        coordinator.merge_poll_state(pallet)

    prover = poll_prover(keys, pallet, coordinator, device)

    with clock("witness_inputs"):
        process_batches, tally_batches, tb = prover.get_poll_results()

    batches, first = [], None
    for kind, circuit, pk, jobs in (("process", pc, process_pk,
                                     process_batches),
                                    ("tally", tc, tally_pk, tally_batches)):
        for i, (values, meta) in enumerate(jobs):
            with clock(f"witness_{kind}_{i}"):
                w = circuit.assignment(values)
            with clock(f"prove_{kind}_{i}"):
                proof = g16.prove(pk, circuit.cs, w, rng=prover.rng,
                                  device=device)
            with clock(f"selfverify_{kind}_{i}"):
                publics = circuit.public_inputs(values)
                if not g16.verify(pk.vk, proof, publics):
                    raise AssertionError(f"{kind} self-verify failed")
            if first is None:
                first = dict(values=values, witness=w, proof=proof,
                             publics=publics)
            batches.append((serialize_proof(proof),
                            fr_to_hash_bytes(meta["new_commitment"])))
        timings[f"trace_{kind}"] = dict(g16.LAST_PROVE_TRACE)  # steady batch

    with clock("commit_outcome"):
        outcome = prover._outcome(tb)
        pallet.commit_outcome("alice", batches, outcome)
    if pallet.polls[0].outcome != 5:
        raise AssertionError(f"wrong outcome {pallet.polls[0].outcome}")

    timings["proof_latency_s"] = proof_latency(timings)
    timings["num_proofs"] = len(batches)
    timings["total_s"] = round(sum(
        v for v in timings.values() if isinstance(v, float)), 3)
    timings["outcome"] = 5
    return E2ERun(timings, keys, pallet, coordinator, first)
