"""One tally batch of a small poll through the port's PollProver, on the CPU.

A poll with TallyCircuit(3,1,1) (4,264 constraints, domain 2^13) runs its
lifecycle on the reference InfimumPallet. The port's PollProver replays the
pallet's events, and proves tally batch 0 with the port's setup and prove.
The proof must equal the reference prove's with the same key and rng, and
the pallet must accept it against its own public inputs.

The matching ProcessCircuit(3,1,1,1) has about 100k constraints (domain
2^17), beyond what the plain CPU path proves in a test's time, so the
process batches are not proved: their commitments are committed on the
pallet's poll directly, which is what an accepted process proof does. The
coordinator registers the tally vkey in the process slot; no process proof
is ever checked against it."""

import random

import pytest

from infimum_tpu.circuits.process import ProcessCircuit
from infimum_tpu.circuits.tally import TallyCircuit
from infimum_tpu.client.user import Participant
from infimum_tpu.groth16 import groth16 as ref
from infimum_tpu.io.arkworks import (
    fr_to_hash_bytes, serialize_proof, serialize_vkey,
)
from infimum_tpu.maci.keys import Keypair
from infimum_tpu.pallet import InfimumPallet
from infimum_tpu_torch.client.prover import PollProver, ProverKeys
from infimum_tpu_torch.groth16 import groth16 as port


@pytest.mark.slow
def test_tally_batch_through_poll_prover(monkeypatch):
    monkeypatch.setenv("INFIMUM_HOST_H_THRESHOLD", "0")
    pc = ProcessCircuit(state_tree_depth=3, msg_tree_depth=1,
                        msg_batch_depth=1, vote_option_tree_depth=1,
                        build=False)
    tc = TallyCircuit(state_tree_depth=3, int_state_tree_depth=1,
                      vote_option_tree_depth=1)
    assert len(tc.cs.constraints) == 4264
    tally_pk = port.setup(tc.cs, random.Random(5), device="cpu")
    ref_pk = ref.setup(tc.cs, random.Random(5))
    assert tally_pk.h_query == ref_pk.h_query
    assert vars(tally_pk.vk) == vars(ref_pk.vk)

    coordinator = Keypair(sk=0xA11CE)
    vk = serialize_vkey(tally_pk.vk)
    pallet = InfimumPallet()
    pallet.register_as_coordinator("alice", coordinator.pub,
                                   {"process": vk, "tally": vk})
    pallet.create_poll("alice", 12, 12, 3, 1, 1, 1, 1, list(range(5)))
    pallet.run_to_block(2)
    voters = [Participant(n, sk) for n, sk in
              (("bob", 0xB0B), ("charlie", 0xC0C), ("dave", 0xD0D))]
    for p in voters:
        p.register(pallet, 0)
    pallet.run_to_block(14)
    pallet.merge_poll_state("alice")
    voters[0].vote(pallet, 0, coordinator.pub, state_index=1, vote_option=2,
                   weight=1, nonce=1)
    pallet.run_to_block(26)
    pallet.merge_poll_state("alice")
    poll = pallet.polls[0]

    keys = ProverKeys(pc, tc, None, tally_pk)
    prover = PollProver(keys, coordinator, poll.config,
                        poll_end_timestamp=poll.voting_period_end(),
                        rng=random.Random(7), device="cpu")
    prover.ingest_events(pallet.events, 0)
    process_batches, tally_batches, _ = prover.get_poll_results()
    for _, meta in process_batches:
        kind, _, new_c = poll.prepare_public_inputs(coordinator.pub,
                                                    meta["new_commitment"])
        assert kind == "process"
        poll.commit(new_c)

    values, meta = tally_batches[0]
    witness = tc.assignment(values)
    rng_state = prover.rng.getstate()
    proof = prover.prove_batch(tc, tally_pk, values, witness)
    ref_rng = random.Random()
    ref_rng.setstate(rng_state)
    want = ref.prove(ref_pk, tc.cs, witness, ref_rng)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)

    pallet.commit_outcome("alice", [(serialize_proof(proof),
                                     fr_to_hash_bytes(meta["new_commitment"]))])
    assert poll.commitment.tally[0] == 1
