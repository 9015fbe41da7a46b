"""Poll proving orchestration on the port's Groth16.

Counterpart of `infimum_tpu/client/prover.py`: `ProverKeys` builds both
circuits and loads their keys through the on-disk key cache
(`groth16/pkcache.py`), `prewarm` builds the CUDA kernels and runs one
throwaway proof per circuit before batch 0; `PollProver` replays the poll's
events, drains the process and tally batches exactly as the reference
does, proves each batch with this package's `prove` and self-verifies it
with the native pairing before it is handed on.

Witnesses are computed in this process on a worker thread, ahead of the
proof in flight on the card: at the measured traffic a process witness
(0.44-0.84 s on an H100 host) is shorter than its proof, so the thread
hides every witness after the first. INFIMUM_PARALLEL_WITNESS=1 takes the
reference's path instead, forked worker processes (`witness/parallel.py`)
streamed in order; the children run only `circuit.assignment` (the native
hint program or Python hints) and never touch the CUDA context this
process holds. On an H100 host (`chip_smoke.py` phase 10) the
reference-dims poll's 3 + 3 batches ran on forked workers with no worker
timing out and gave the same batches, byte for byte, as the thread, but
1.1-1.9 s slower over the 6 batches. Where the workers would gain, a
witness that outlasts its proof, was not measured, so they stay off by
default (the reference defaults them on).
"""

from __future__ import annotations

import itertools
import os
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from ..circuits.process import ProcessCircuit
from ..circuits.tally import TallyCircuit
from ..groth16.groth16 import ProvingKey, prove, verify
from ..groth16.pkcache import setup_cached
from ..hash.poseidon_host import poseidon
from ..io.arkworks import fr_to_hash_bytes, serialize_proof, serialize_vkey
from ..maci.keys import Keypair
from ..maci.replay import MaciReplay
from ..maci.state import PollOutcome
from ..tree.full import FullTree
from ..witness.process import ProcessWitnessBuilder
from ..witness.tally import Ballot, TallyWitnessBuilder


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
                 device="cuda") -> "ProverKeys":
        """Build both circuits and load their keys from the key cache, or
        run the (single-party) setup on `device` and cache them, process
        first, as the reference does."""
        rng = rng or random.Random(0xC0FFEE)
        pc, tc = cls.circuits(registration_depth, interaction_depth,
                              process_subtree_depth, tally_subtree_depth,
                              vote_option_tree_depth)
        return cls(pc, tc,
                   setup_cached(pc.cs, rng, label="process", device=device),
                   setup_cached(tc.cs, rng, label="tally", device=device))

    @classmethod
    def dims_only(cls, registration_depth: int, interaction_depth: int,
                  process_subtree_depth: int, tally_subtree_depth: int,
                  vote_option_tree_depth: int) -> "ProverKeys":
        """Circuit dimensions without constraint systems or keys: enough for
        witness inputs and commitment chaining, not for proving."""
        pc, tc = cls.circuits(registration_depth, interaction_depth,
                              process_subtree_depth, tally_subtree_depth,
                              vote_option_tree_depth, build=False)
        return cls(pc, tc, None, None)

    def vkeys(self) -> dict:
        """Pallet-shaped {process, tally} vkey byte dicts, the registration
        payload of register_as_coordinator."""
        return {
            "process": serialize_vkey(self.process_pk.vk),
            "tally": serialize_vkey(self.tally_pk.vk),
        }

    def prewarm(self, verbose: bool = True, device="cuda") -> dict:
        """Ready everything batch 0 would otherwise pay for: on a card, the
        CUDA kernels (built, or loaded from `build/`); the native
        hint-program compile; one throwaway proof per circuit over a zero
        witness on `device` (query encodings, row layouts, the MSM shapes).
        Returns {prewarm_s, kernel_load_log}: one entry per CUDA source,
        {kernel, path: "built" | "cached", s}, empty on the CPU. Raises
        when the kernels cannot build or launch."""
        from .. import kernels

        t0 = time.perf_counter()
        load_log = []
        if torch.device(device).type == "cuda":
            kernels.library()
            load_log = [{"kernel": src,
                         "path": "cached" if s is None else "built",
                         "s": round(s or 0.0, 3)}
                        for src, s in kernels.BUILD_INFO["sources"].items()]
        for circuit, pk in ((self.process_circuit, self.process_pk),
                            (self.tally_circuit, self.tally_pk)):
            if pk is None:
                continue
            circuit.cs._native_prog()   # one-time hint-program compile
            prove(pk, circuit.cs, [0] * circuit.cs.num_vars,
                  rng=random.Random(0), device=device)
        out = {"prewarm_s": round(time.perf_counter() - t0, 3),
               "kernel_load_log": load_log}
        if verbose:
            print(f"[prewarm] {out['prewarm_s']}s, kernels: {load_log}",
                  file=sys.stderr, flush=True)
        return out


class PollProver:
    """Per-poll proving session: replays events, emits proof batches and
    the outcome. With INFIMUM_PARALLEL_WITNESS=1, `prove_poll_results`
    forks its witness workers from this process with CUDA already
    initialised, which the card run allows: the children never call torch
    (module note)."""

    def __init__(self, keys: ProverKeys, coordinator: Keypair, poll_config,
                 poll_end_timestamp: int, rng: random.Random | None = None,
                 device="cuda"):
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

    def _prove_one(self, circuit, pk: ProvingKey, values) -> dict:
        """Witness, prove and self-verify one batch; the serialized proof."""
        witness = circuit.assignment(values)
        proof = prove(pk, circuit.cs, witness, rng=self.rng,
                      device=self.device)
        if not verify(pk.vk, proof, circuit.public_inputs(values)):
            raise AssertionError("self-verification failed")
        return serialize_proof(proof)

    def prove_poll_results(self):
        """(proof_batches, outcome) ready for commit_outcome: every batch as
        (serialized proof, new commitment bytes). A worker thread computes
        the witnesses ahead of the proof in flight; with
        INFIMUM_PARALLEL_WITNESS=1, more than one CPU and more than one
        job, they stream in order from forked workers
        (witness/parallel.py iter_assignments) instead."""
        process_batches, tally_batches, tb = self.get_poll_results()
        jobs = [(self.keys.process_circuit, self.keys.process_pk, v, m)
                for v, m in process_batches]
        jobs += [(self.keys.tally_circuit, self.keys.tally_pk, v, m)
                 for v, m in tally_batches]

        use_mp = (os.environ.get("INFIMUM_PARALLEL_WITNESS", "0") == "1"
                  and (os.cpu_count() or 1) > 1 and len(jobs) > 1)
        if use_mp:
            from ..witness.parallel import iter_assignments

            witnesses = itertools.chain(
                iter_assignments(self.keys.process_circuit,
                                 [v for v, _ in process_batches]),
                iter_assignments(self.keys.tally_circuit,
                                 [v for v, _ in tally_batches]))
            batches = self._prove_stream(jobs, lambda: next(witnesses))
        else:
            with ThreadPoolExecutor(max_workers=1) as ex:
                futs = iter([ex.submit(c.assignment, v)
                             for c, _, v, _ in jobs])
                batches = self._prove_stream(jobs,
                                             lambda: next(futs).result())
        return batches, self._outcome(tb)

    def _prove_stream(self, jobs, next_witness):
        batches = []
        for circuit, pk, values, meta in jobs:
            witness = next_witness()
            proof = prove(pk, circuit.cs, witness, rng=self.rng,
                          device=self.device)
            if not verify(pk.vk, proof, circuit.public_inputs(values)):
                raise AssertionError("self-verification failed")
            batches.append((serialize_proof(proof),
                            fr_to_hash_bytes(meta["new_commitment"])))
        return batches

    def _outcome(self, tb: TallyWitnessBuilder) -> PollOutcome:
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
