"""The traffic generator: a closed poll made from the seed, and the batches
its coordinator has to prove.

The poll's life follows `infimum_tpu_torch/client/scale.py`
`run_scale_poll` (copied here, so that the yardstick does not move with the
program): a coordinator registers and opens a poll, the participants sign
up, each publishes its votes (sign, encrypt, insert), the coordinator
merges the state and the messages, replays the pallet's events and walks
the witness inputs of every process batch (the commitment chain forces the
whole walk, last batch first), then those of the tally batches in order.

From `seed` come every participant's key, each vote's option, salt and
ephemeral key, the coordinator's key, and the salts of the batches. The
sizes (sign-ups, messages, batches) come from the configuration alone, so
every seed makes the same work.
"""

from __future__ import annotations

import random

from infimum_tpu_torch.client.prover import PollProver
from infimum_tpu_torch.client.user import Coordinator, Participant
from infimum_tpu_torch.groth16.groth16 import setup
from infimum_tpu_torch.groth16.r1cs import LC, ConstraintSystem
from infimum_tpu_torch.io.arkworks import serialize_vkey
from infimum_tpu_torch.pallet import InfimumPallet
from infimum_tpu_torch.witness.process import ProcessWitnessBuilder
from infimum_tpu_torch.witness.tally import Ballot, TallyWitnessBuilder

SIGNUP_PERIOD, VOTING_PERIOD = 12, 12


def _placeholder_vkeys() -> dict:
    """Deserializable vkeys of a one-constraint setup on the host: the
    pallet's registration only checks their encoding, and no proof of this
    poll goes to the pallet."""
    cs = ConstraintSystem()
    x = cs.alloc_public()
    cs.enforce(LC.var(x), LC.var(x), LC.var(x))
    vk = serialize_vkey(setup(cs, random.Random(1), "cpu").vk)
    return {"process": vk, "tally": vk}


def closed_poll(keys, config: dict, seed: int) -> PollProver:
    """The coordinator's PollProver of a poll whose voting period has
    ended, with every pallet event replayed into it."""
    rng = random.Random(seed)
    n_signups, n_messages = config["n_signups"], config["n_messages"]
    if n_signups > 2 ** config["registration_depth"] - 2:
        raise ValueError("stay below the blank-leaf bound")
    if n_messages > 5 ** config["interaction_depth"] - 1:
        raise ValueError("stay below the full-tree merge quirk")
    n_options = 5 ** config["vote_option_tree_depth"]

    coordinator = Coordinator("coord", sk=rng.getrandbits(250), keys=keys)
    participants = [Participant(f"p{i}", sk=rng.getrandbits(250))
                    for i in range(n_signups)]
    pallet = InfimumPallet()
    pallet.register_as_coordinator("coord", coordinator.public_key,
                                   _placeholder_vkeys())
    coordinator.create_poll(pallet, SIGNUP_PERIOD, VOTING_PERIOD)
    pallet.run_to_block(2)
    for p in participants:
        p.register(pallet, 0)
    pallet.run_to_block(2 + SIGNUP_PERIOD)
    coordinator.merge_poll_state(pallet)
    for i in range(n_messages):
        k = i % n_signups
        participants[k].vote(
            pallet, 0, coordinator.public_key, state_index=1 + k,
            vote_option=rng.randrange(n_options), weight=1, nonce=1,
            salt=rng.getrandbits(200), eph_sk=rng.getrandbits(250))
    pallet.run_to_block(2 + SIGNUP_PERIOD + VOTING_PERIOD)
    coordinator.merge_poll_state(pallet)

    poll = pallet.polls[0]
    prover = PollProver(keys, coordinator.keypair, poll.config,
                        poll_end_timestamp=poll.voting_period_end(),
                        rng=random.Random(rng.getrandbits(64)), device="cpu")
    prover.ingest_events(pallet.events, 0)
    return prover


def batches(prover: PollProver, circuit: str, count: int) -> list[dict]:
    """The circuit values of the first `count` batches of `circuit`
    ("process" or "tally") in the order the coordinator proves them, as
    `PollProver.get_poll_results` makes them."""
    pb = ProcessWitnessBuilder(prover.keys.process_circuit, prover.replay)
    process = [values for values, _ in pb.batches(prover.rng)]
    if circuit == "process":
        if count > len(process):
            raise ValueError(f"{count} process batches asked, the poll has "
                             f"{len(process)}")
        return process[:count]
    ballots = [Ballot(nonce=b.nonce, votes=list(b.votes))
               for b in prover.replay.ballots]
    tb = TallyWitnessBuilder(prover.keys.tally_circuit,
                             state_root=pb.state_tree.root,
                             sb_salt=pb.sb_salt, ballots=ballots,
                             num_signups=prover.replay.num_signups)
    if count > tb.num_batches:
        raise ValueError(f"{count} tally batches asked, the poll has "
                         f"{tb.num_batches}")
    return [tb.batch_inputs(prover.rng)[0] for _ in range(count)]
