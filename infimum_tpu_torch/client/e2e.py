"""Reference-dims end-to-end poll on the port, with per-phase timings.

Counterpart of `infimum_tpu/client/e2e.py` `run_reference_e2e`: the same
instantiation (ProcessMessages(10,2,1,2), domain 2^18, and
TallyVotes(10,1,2), domain 2^14), the same participants, votes and seeds.
The reference drives its lifecycle through the pallet, which imports the
JAX package; here the lifecycle drives the port's `maci.state.Poll`
directly, builds the vote messages as `client/user.py` does, and checks
every proof against the poll's own public inputs before committing it,
as `pallet/chain.py` `commit_outcome` does.
"""

from __future__ import annotations

import contextlib
import random
import sys
import time
from dataclasses import dataclass

from ..groth16.groth16 import prove, setup, verify
from ..hash.cipher import poseidon_encrypt
from ..hash.poseidon_host import poseidon
from ..io.arkworks import (
    deserialize_proof, fr_from_hash_bytes, fr_to_hash_bytes, serialize_proof,
)
from ..maci.keys import Keypair
from ..maci.replay import pack_command
from ..maci.state import Poll, PollConfig
from .prover import PollProver, ProverKeys

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
    first_process: dict     # values, witness, proof, publics of batch 0


def vote_message(keypair: Keypair, origin, poll_id: int, coordinator_pub,
                 state_index: int, vote_option: int, weight: int, nonce: int,
                 salt: int):
    """(ephemeral public key, 10-element message): packed command, EdDSA-
    Poseidon signature, ECDH with the coordinator, Poseidon cipher, as
    `client/user.py` Participant.vote builds it."""
    rng = random.Random(f"{origin}/{state_index}/{nonce}/{vote_option}")
    packed = pack_command(state_index, vote_option, weight, nonce, poll_id,
                          keypair.pub, salt)
    sig_r8, sig_s = keypair.sign(poseidon(packed))
    eph = Keypair(sk=rng.getrandbits(250))
    data = poseidon_encrypt(packed + [sig_r8[0], sig_r8[1], sig_s],
                            eph.ecdh(coordinator_pub), 0)
    return eph.pub, data


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


def _lifecycle(config: dict, coordinator: Keypair):
    """Blocks 1..26 of the reference e2e on a bare Poll: five sign-ups,
    eleven votes (only the last is valid: messages are processed in reverse
    order), both merges. Returns (poll, sign-ups, interactions)."""
    d = config["vote_option_tree_depth"]
    poll = Poll(index=0, created_at=1, config=PollConfig(
        signup_period=SIGNUP, voting_period=VOTING,
        registration_depth=config["registration_depth"],
        interaction_depth=config["interaction_depth"],
        process_subtree_depth=config["process_subtree_depth"],
        tally_subtree_depth=config["tally_subtree_depth"],
        vote_option_tree_depth=d, vote_options=list(range(5 ** d)),
        max_registrations=2 ** config["registration_depth"],
        max_interactions=5 ** config["interaction_depth"]))
    voters = [(name, Keypair(sk=sk)) for name, sk in PARTICIPANTS]
    signups = []
    assert poll.is_registration_period(2)
    for _, kp in voters:
        poll.register_participant(kp.pub, 2)
        signups.append((kp.pub, 2))
    assert not poll.is_registration_period(14)
    poll.merge_registrations()
    interactions = []
    assert poll.is_voting_period(14)
    name, kp = voters[0]
    for i in range(11):
        eph_pub, data = vote_message(kp, name, 0, coordinator.pub,
                                     state_index=1, vote_option=5, weight=1,
                                     nonce=1, salt=1000 + i)
        poll.consume_interaction(eph_pub, list(data))
        interactions.append((list(data), eph_pub))
    assert poll.is_over(26)
    poll.merge_interactions()
    return poll, signups, interactions


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
    """The whole poll at (default) reference dims on `device`: circuit
    build, setup, lifecycle, every batch witnessed, proved and
    self-verified (each timed apart), then each proof checked against the
    poll's public inputs and the outcome verified (option 5). Raises on
    any failure."""
    config = dict(REFERENCE_CONFIG if config is None else config)
    timings: dict = {}
    clock = _clock(timings, verbose)

    with clock("build_circuits"):
        pc, tc = ProverKeys.circuits(**config)
    timings["process_constraints"] = len(pc.cs.constraints)
    timings["tally_constraints"] = len(tc.cs.constraints)
    rng = random.Random(seed)
    with clock("setup_process"):
        process_pk = setup(pc.cs, rng, device)
    with clock("setup_tally"):
        tally_pk = setup(tc.cs, rng, device)
    keys = ProverKeys(pc, tc, process_pk, tally_pk)

    coordinator = Keypair(sk=COORDINATOR_SK)
    with clock("lifecycle"):
        poll, signups, interactions = _lifecycle(config, coordinator)
    prover = PollProver(keys, coordinator, poll.config,
                        poll_end_timestamp=poll.voting_period_end(),
                        rng=random.Random(7), device=device)
    for pub, block in signups:
        prover.replay.sign_up(pub, timestamp=block)
    for data, pub in interactions:
        prover.replay.publish(data, pub)
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
                proof = prove(pk, circuit.cs, w, rng=prover.rng,
                              device=device)
            with clock(f"selfverify_{kind}_{i}"):
                if not verify(pk.vk, proof, circuit.public_inputs(values)):
                    raise AssertionError(f"{kind} self-verify failed")
            if first is None:
                first = dict(values=values, witness=w, proof=proof,
                             publics=circuit.public_inputs(values))
            batches.append((serialize_proof(proof),
                            fr_to_hash_bytes(meta["new_commitment"])))

    with clock("commit_outcome"):
        vks = {"process": process_pk.vk, "tally": tally_pk.vk}
        for proof_bytes, commitment in batches:
            kind, inputs, new_c = poll.prepare_public_inputs(
                coordinator.pub, fr_from_hash_bytes(commitment))
            if not verify(vks[kind], deserialize_proof(proof_bytes), inputs):
                raise AssertionError(f"{kind} proof rejected")
            poll.commit(new_c)
        outcome = poll.verify_outcome(prover.outcome(tb))
    if outcome != 5:
        raise AssertionError(f"wrong outcome {outcome}")

    timings["proof_latency_s"] = proof_latency(timings)
    timings["num_proofs"] = len(batches)
    timings["outcome"] = outcome
    return E2ERun(timings, keys, first)
