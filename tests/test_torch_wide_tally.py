"""Tally batches wider than the shipped 2 ballots on the port's path, on the
CPU.

The pallet takes a poll at the reference runtime's registration bound
with a tally depth of 7 (128 ballots a batch, the largest under the
reference's 2^19 powers of tau) and refuses one past either bound. A small
poll of the same kind, registration depth 5, tally depth 3 (8 ballots a
batch) and vote-option depth 2 (25 options), runs its lifecycle on the
port's pallet and roles: 20 sign-ups and the blank leaf make 21 ballots,
so its three tally batches hold 8, 8 and 5. The port's PollProver walks
its batches; each batch's running per-option totals and spent voice
credits equal plain Python sums over the votes cast (nothing of the port
computes them), and each batch's witness satisfies TallyCircuit(5,3,2).
One batch of a smaller wide poll, proved by the port on the CPU, equals
the benchmark's plain reference (`benchmark/harness/reference.py`) under
the same key seed, r and s."""

import json
import pathlib
import random
import sys

import pytest
import torch

from infimum_tpu_torch.circuits.tally import TallyCircuit
from infimum_tpu_torch.client import Coordinator, Participant, PollProver
from infimum_tpu_torch.client.prover import ProverKeys
from infimum_tpu_torch.groth16 import groth16 as g16
from infimum_tpu_torch.maci.keys import Keypair
from infimum_tpu_torch.pallet import Error, InfimumPallet, PalletError

torch.set_num_threads(1)  # the suite runs in parallel worker processes

WIDE = dict(registration_depth=5, interaction_depth=2,
            process_subtree_depth=1, tally_subtree_depth=3,
            vote_option_tree_depth=2)
N_SIGNUPS = 20
VOTERS = 17          # sign-ups 17..19 cast no vote
PERIOD = 12
KEY_SEED = 20261023
# deserializable vkeys: the pallet checks their encoding; no proof of these
# polls goes to it
VKEYS = json.loads((pathlib.Path(__file__).parent / "data" /
                    "ref_groth16_fixtures.json").read_text())["vkeys"]


def _coordinator_pallet():
    pallet = InfimumPallet()
    pallet.register_as_coordinator("alice", Keypair(sk=0xA11CE).pub, VKEYS)
    return pallet


@pytest.mark.parametrize("depths", [(16, 6, 1, 7, 2), (10, 2, 1, 1, 2),
                                    (5, 2, 1, 3, 2)])
def test_create_poll_accepts_wide_tally_batches(depths):
    pallet = _coordinator_pallet()
    poll_id = pallet.create_poll("alice", PERIOD, PERIOD, *depths,
                                 list(range(5 ** depths[-1])))
    config = pallet.polls[poll_id].config
    assert (config.registration_depth, config.tally_subtree_depth) == (
        depths[0], depths[3])
    assert config.max_registrations == 2 ** depths[0]


@pytest.mark.parametrize("depths", [
    (17, 6, 1, 7, 2),     # 2^17 registrations: past MaxPollRegistrations
    (5, 2, 1, 6, 2),      # tally depth above the registration depth
    (16, 7, 1, 7, 2),     # 5^7 interactions: past MaxPollInteractions
    (16, 6, 1, 7, 3)])    # 125 vote options: past MaxVoteOptions
def test_create_poll_refuses_past_the_bounds(depths):
    pallet = _coordinator_pallet()
    with pytest.raises(PalletError) as err:
        pallet.create_poll("alice", PERIOD, PERIOD, *depths,
                           list(range(5 ** depths[-1])))
    assert err.value.error == Error.PollConfigInvalid


def _run_poll(depths: dict, n_signups: int, voters: int):
    """A closed poll of `n_signups` on the port's pallet and roles, the
    first `voters` voting one credit each for an option drawn from a seed,
    walked by the port's PollProver: (tally circuit, tally batches, its
    TallyWitnessBuilder, the option voted by state index)."""
    rng = random.Random(20261023)
    dims = ProverKeys.dims_only(**depths)
    tc = TallyCircuit(state_tree_depth=depths["registration_depth"],
                      int_state_tree_depth=depths["tally_subtree_depth"],
                      vote_option_tree_depth=depths["vote_option_tree_depth"])
    keys = ProverKeys(dims.process_circuit, tc, None, None)
    coordinator = Coordinator("alice", sk=rng.getrandbits(250), keys=keys)
    participants = [Participant(f"p{i}", sk=rng.getrandbits(250))
                    for i in range(n_signups)]
    pallet = InfimumPallet()
    pallet.register_as_coordinator("alice", coordinator.public_key, VKEYS)
    coordinator.create_poll(pallet, PERIOD, PERIOD)
    pallet.run_to_block(2)
    for p in participants:
        p.register(pallet, 0)
    pallet.run_to_block(2 + PERIOD)
    coordinator.merge_poll_state(pallet)
    voted = {}
    for k in range(voters):
        option = rng.randrange(5 ** depths["vote_option_tree_depth"])
        participants[k].vote(pallet, 0, coordinator.public_key,
                             state_index=1 + k, vote_option=option, weight=1,
                             nonce=1, salt=rng.getrandbits(200),
                             eph_sk=rng.getrandbits(250))
        voted[1 + k] = option
    pallet.run_to_block(2 + 2 * PERIOD)
    coordinator.merge_poll_state(pallet)
    poll = pallet.polls[0]
    prover = PollProver(keys, coordinator.keypair, poll.config,
                        poll_end_timestamp=poll.voting_period_end(),
                        rng=random.Random(rng.getrandbits(64)), device="cpu")
    prover.ingest_events(pallet.events, 0)
    _, tally_batches, tb = prover.get_poll_results()
    return tc, tally_batches, tb, voted


@pytest.fixture(scope="module")
def wide_poll():
    return _run_poll(WIDE, N_SIGNUPS, VOTERS)


def test_wide_poll_has_a_partial_last_batch(wide_poll):
    tc, batches, tb, _ = wide_poll
    assert tc.batch_size == 8
    assert len(tb.ballots) == N_SIGNUPS + 1          # the blank leaf first
    assert tb.num_batches == len(batches) == 3
    assert [v["index"] for v, _ in batches] == [0, 8, 16]
    held = [min(tc.batch_size, len(tb.ballots) - v["index"])
            for v, _ in batches]
    assert held == [8, 8, 5]
    # the last batch's slots past the ballots are blank, with no votes
    last_votes = batches[-1][0]["votes"]
    assert all(not any(row) for row in last_votes[5:])


def _plain_tally(voted: dict, upto: int, options: int):
    """Per-option totals and spent voice credits of the ballots of state
    index below `upto`: one credit a vote, the option's total counts it."""
    totals = [0] * options
    for index, option in voted.items():
        if index < upto:
            totals[option] += 1
    return totals, sum(totals)


def test_batch_totals_equal_plain_sums(wide_poll):
    tc, batches, _, voted = wide_poll
    for values, meta in batches:
        upto = values["index"] + tc.batch_size
        totals, spent = _plain_tally(voted, upto, tc.num_vote_options)
        assert meta["results"] == totals
        assert meta["spent"] == spent
    # the last batch's totals are the poll's
    assert batches[-1][1]["spent"] == VOTERS


def test_batch_witnesses_satisfy_the_circuit(wide_poll):
    tc, batches, _, _ = wide_poll
    for values, _ in batches:
        witness = tc.assignment(values)
        assert tc.cs.check(witness)
        assert tc.public_inputs(values) == tc.cs.public_values(witness)


def test_wide_batch_proof_equals_the_plain_reference():
    # A smaller wide poll, TallyCircuit(3,2,1): 4 ballots a batch, 5,624
    # constraints (2^13): the plain CPU path sets up TallyCircuit(5,3,2)'s
    # key in about 4 minutes. 5 sign-ups and the blank leaf make two
    # batches; the last, partial one is proved by the port and worked out
    # by the benchmark's plain reference from the key's trapdoor.
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "benchmark"))
    from harness.reference import Groth16Reference, proof_randomness

    depths = dict(registration_depth=3, interaction_depth=1,
                  process_subtree_depth=1, tally_subtree_depth=2,
                  vote_option_tree_depth=1)
    tc, batches, tb, _ = _run_poll(depths, n_signups=5, voters=4)
    assert (tc.batch_size, len(batches), len(tb.ballots)) == (4, 2, 6)
    values = batches[-1][0]
    witness = tc.assignment(values)
    pk = g16.setup(tc.cs, random.Random(KEY_SEED), device="cpu")
    proof = g16.prove(pk, tc.cs, witness, random.Random(KEY_SEED + 1),
                      device="cpu")
    ref = Groth16Reference(tc.cs, KEY_SEED)
    want = ref.proof(ref.witness_sums(witness),
                     *proof_randomness(random.Random(KEY_SEED + 1)))
    assert (proof.a, proof.b, proof.c) == want
    assert g16.verify(pk.vk, proof, tc.public_inputs(values))
