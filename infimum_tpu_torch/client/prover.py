"""Poll proving orchestration on the port's Groth16.

Counterpart of `infimum_tpu/client/prover.py`: `ProverKeys` builds both
circuits and runs this package's setup; `PollProver` replays the poll's
events, drains the process and tally batches exactly as the reference
does, proves each batch with this package's `prove` and self-verifies it
with the native pairing before it is handed on.

Witnesses are computed in this process, one batch ahead of the proof in
flight on a single worker thread (the reference's INFIMUM_PARALLEL_WITNESS=0
branch): the reference's forked witness workers must not be used once CUDA
is initialised in the parent.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..groth16.groth16 import ProvingKey, prove, setup, verify
from infimum_tpu.circuits.process import ProcessCircuit
from infimum_tpu.circuits.tally import TallyCircuit
from infimum_tpu.hash.poseidon_host import poseidon
from infimum_tpu.io.arkworks import fr_to_hash_bytes, serialize_proof
from infimum_tpu.maci.keys import Keypair
from infimum_tpu.maci.replay import MaciReplay
from infimum_tpu.maci.state import PollOutcome
from infimum_tpu.tree.full import FullTree
from infimum_tpu.witness.process import ProcessWitnessBuilder
from infimum_tpu.witness.tally import Ballot, TallyWitnessBuilder


@dataclass
class ProverKeys:
    """Both circuits of a poll configuration and their proving keys."""

    process_circuit: ProcessCircuit
    tally_circuit: TallyCircuit
    process_pk: ProvingKey | None
    tally_pk: ProvingKey | None

    @staticmethod
    def circuits(registration_depth: int, interaction_depth: int,
                 process_subtree_depth: int, tally_subtree_depth: int,
                 vote_option_tree_depth: int, build: bool = True):
        pc = ProcessCircuit(
            state_tree_depth=registration_depth,
            msg_tree_depth=interaction_depth,
            msg_batch_depth=process_subtree_depth,
            vote_option_tree_depth=vote_option_tree_depth, build=build)
        tc = TallyCircuit(
            state_tree_depth=registration_depth,
            int_state_tree_depth=tally_subtree_depth,
            vote_option_tree_depth=vote_option_tree_depth, build=build)
        return pc, tc

    @classmethod
    def generate(cls, registration_depth: int, interaction_depth: int,
                 process_subtree_depth: int, tally_subtree_depth: int,
                 vote_option_tree_depth: int,
                 rng: random.Random | None = None,
                 device="cpu") -> "ProverKeys":
        """Build both circuits and run the (single-party) setup on
        `device`, process first, as the reference does."""
        rng = rng or random.Random(0xC0FFEE)
        pc, tc = cls.circuits(registration_depth, interaction_depth,
                              process_subtree_depth, tally_subtree_depth,
                              vote_option_tree_depth)
        return cls(pc, tc, setup(pc.cs, rng, device),
                   setup(tc.cs, rng, device))


class PollProver:
    """Per-poll proving session: replays events, emits proof batches and
    the outcome."""

    def __init__(self, keys: ProverKeys, coordinator: Keypair, poll_config,
                 poll_end_timestamp: int, rng: random.Random | None = None,
                 device="cpu"):
        self.keys = keys
        self.rng = rng or random.Random(0x5EED)
        self.device = device
        self.config = poll_config
        self.replay = MaciReplay(
            state_tree_depth=poll_config.registration_depth,
            msg_tree_depth=poll_config.interaction_depth,
            msg_batch_depth=poll_config.process_subtree_depth,
            vote_option_tree_depth=poll_config.vote_option_tree_depth,
            coordinator=coordinator,
            poll_end_timestamp=poll_end_timestamp,
        )

    def ingest_events(self, events, poll_index: int):
        """Feed pallet events (ParticipantRegistered / PollInteraction)."""
        for ev in events:
            if ev.name == "ParticipantRegistered" and ev.data["poll"] == poll_index:
                self.replay.sign_up(tuple(ev.data["public_key"]),
                                    timestamp=ev.data["block"])
            elif ev.name == "PollInteraction" and ev.data["poll"] == poll_index:
                self.replay.publish(list(ev.data["data"]),
                                    tuple(ev.data["public_key"]))

    def get_poll_results(self):
        """Drain every process batch, then every tally batch:
        (process_batches, tally_batches, tally_builder), each batch
        (circuit_values, meta)."""
        pb = ProcessWitnessBuilder(self.keys.process_circuit, self.replay)
        process_batches = list(pb.batches(self.rng))
        ballots = [Ballot(nonce=b.nonce, votes=list(b.votes))
                   for b in self.replay.ballots]
        tb = TallyWitnessBuilder(
            self.keys.tally_circuit,
            state_root=pb.state_tree.root,
            sb_salt=pb.sb_salt,
            ballots=ballots,
            num_signups=self.replay.num_signups,
        )
        tally_batches = [tb.batch_inputs(self.rng)
                         for _ in range(tb.num_batches)]
        return process_batches, tally_batches, tb

    def prove_batch(self, circuit, pk: ProvingKey, values, witness=None):
        """Prove one batch and self-verify it against the circuit's public
        inputs; returns the Proof."""
        if witness is None:
            witness = circuit.assignment(values)
        proof = prove(pk, circuit.cs, witness, rng=self.rng,
                      device=self.device)
        if not verify(pk.vk, proof, circuit.public_inputs(values)):
            raise AssertionError("self-verification failed")
        return proof

    def prove_poll_results(self):
        """(proof_batches, outcome) ready for commit_outcome: every batch as
        (serialized proof, new commitment bytes)."""
        process_batches, tally_batches, tb = self.get_poll_results()
        jobs = [(self.keys.process_circuit, self.keys.process_pk, v, m)
                for v, m in process_batches]
        jobs += [(self.keys.tally_circuit, self.keys.tally_pk, v, m)
                 for v, m in tally_batches]
        batches = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            futs = iter([ex.submit(c.assignment, v) for c, _, v, _ in jobs])
            for circuit, pk, values, meta in jobs:
                proof = self.prove_batch(circuit, pk, values,
                                         next(futs).result())
                batches.append((serialize_proof(proof),
                                fr_to_hash_bytes(meta["new_commitment"])))
        return batches, self.outcome(tb)

    def outcome(self, tb: TallyWitnessBuilder) -> PollOutcome:
        """Final results, one quinary inclusion proof per vote option,
        salts and commitments."""
        d = self.config.vote_option_tree_depth
        results_tree = FullTree(5, d, 0, tb.results)
        proofs = [results_tree.path(option)[0]
                  for option in range(len(tb.results))]
        return PollOutcome(
            tally_results=list(tb.results),
            tally_result_proofs=proofs,
            total_spent=tb.spent,
            total_spent_salt=tb._spent_salt,
            tally_result_salt=tb._results_salt,
            new_results_commitment=poseidon([results_tree.root,
                                             tb._results_salt]),
            spent_votes_hash=poseidon([tb.spent, tb._spent_salt]),
        )
