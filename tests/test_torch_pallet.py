"""The port's pallet (infimum_tpu_torch.pallet) and user roles
(infimum_tpu_torch.client) against the reference's.

The reference's test_client_signal_parity_beyond_reference_capacity
(tests/test_client.py) runs through each package's pallet, roles and
`ProverKeys.dims_only`, with the same keys and salts: the public inputs
the pallet derives, the commitments and the outcome are equal, and each
batch's public inputs equal the circuit's. Error cases of
tests/test_pallet.py raise the same `Error` in both pallets, the
reference's real proofs are accepted (and a corrupted one refused) by the
port's pallet through the port's verify, and the typed dispatcher decodes
the same events and errors."""

import importlib
import json
import pathlib
import random

import pytest

import ref_fixtures as fx

FIX = json.loads((pathlib.Path(__file__).parent / "data" /
                  "ref_groth16_fixtures.json").read_text())
PACKAGES = ("infimum_tpu_torch", "infimum_tpu")
CONFIG = dict(registration_depth=10, interaction_depth=2,
              process_subtree_depth=1, tally_subtree_depth=1,
              vote_option_tree_depth=2)
ALICE, BOB, CHARLIE, DAVE = 0, 1, 2, 3


def _signal_parity(name):
    """test_client_signal_parity_beyond_reference_capacity through one
    package: 5 registrations, 11 messages, 3 process + 3 tally batches."""
    client = importlib.import_module(f"{name}.client")
    pallet_mod = importlib.import_module(f"{name}.pallet")
    keys = client.ProverKeys.dims_only(**CONFIG)
    pallet = pallet_mod.InfimumPallet()
    coordinator = client.Coordinator("alice", sk=0xA11CE, keys=keys)
    pallet.register_as_coordinator("alice", coordinator.public_key,
                                   FIX["vkeys"])
    coordinator.create_poll(pallet, 12, 12)
    participants = [client.Participant(n, sk) for n, sk in
                    (("bob", 0xB0B), ("charlie", 0xC0C), ("dave", 0xD0D),
                     ("erin", 0xE417), ("frank", 0xF7A4))]
    pallet.run_to_block(2)
    for p in participants:
        p.register(pallet, 0)
    pallet.run_to_block(14)
    coordinator.merge_poll_state(pallet)
    sent = [participants[0].vote(pallet, 0, coordinator.public_key,
                                 state_index=1, vote_option=5, weight=1,
                                 nonce=1, salt=1000 + i) for i in range(11)]
    pallet.run_to_block(26)
    coordinator.merge_poll_state(pallet)
    poll = pallet.polls[0]
    assert poll.registrations.depth == 3      # 6 leaves: merge raised 2 -> 3
    prover = client.PollProver(keys, coordinator.keypair, poll.config,
                               poll_end_timestamp=poll.voting_period_end(),
                               rng=random.Random(7))
    prover.ingest_events(pallet.events, 0)
    process_batches, tally_batches, tb = prover.get_poll_results()
    assert len(process_batches) == 3 and len(tally_batches) == 3
    signals = []
    for kind, batches, circ in (
            ("process", process_batches, keys.process_circuit),
            ("tally", tally_batches, keys.tally_circuit)):
        for values, meta in batches:
            k, inputs, new_c = poll.prepare_public_inputs(
                coordinator.public_key, meta["new_commitment"])
            assert k == kind
            assert inputs == circ.public_inputs(values)
            poll.commit(new_c)
            signals.append((k, inputs, meta["new_commitment"]))
    outcome = prover._outcome(tb)
    assert poll.verify_outcome(outcome) == 5
    return (sent, signals, vars(outcome), poll.commitment.process,
            poll.commitment.tally, [(e.name, e.data) for e in pallet.events])


def test_client_signal_parity_beyond_reference_capacity():
    got, want = (_signal_parity(name) for name in PACKAGES)
    assert got == want


def _setup_poll(pallet):
    """Blocks 1..26 of the reference's extrinsics flow with its fixtures."""
    pallet.register_as_coordinator(ALICE, fx.COORD_PK, FIX["vkeys"])
    pallet.create_poll(ALICE, 12, 12, 10, 2, 1, 1, 2, list(range(25)))
    pallet.run_to_block(2)
    for origin, pk in zip((BOB, CHARLIE, DAVE), fx.PARTICIPANTS):
        pallet.register_as_participant(origin, 0, pk)
    pallet.run_to_block(14)
    pallet.merge_poll_state(ALICE)
    pallet.interact_with_poll(BOB, 0, fx.SHARED_PK, fx.MESSAGE_DATA)
    pallet.run_to_block(26)
    pallet.merge_poll_state(ALICE)


def already_registered(m):
    p = m.InfimumPallet()
    p.register_as_coordinator(ALICE, fx.COORD_PK, FIX["vkeys"])
    p.register_as_coordinator(ALICE, fx.COORD_PK, FIX["vkeys"])


def not_registered(m):
    m.InfimumPallet().create_poll(BOB, 12, 12, 10, 2, 1, 1, 2,
                                  list(range(25)))


def malformed_vkeys(m):
    bad = {"process": {"alpha_g1": [0] * 64, "beta_g2": [], "gamma_g2": [],
                       "delta_g2": [], "gamma_abc_g1": []},
           "tally": FIX["vkeys"]["tally"]}
    m.InfimumPallet().register_as_coordinator(ALICE, fx.COORD_PK, bad)


def merge_during_registration(m):
    p = m.InfimumPallet()
    p.register_as_coordinator(ALICE, fx.COORD_PK, FIX["vkeys"])
    p.create_poll(ALICE, 12, 12, 10, 2, 1, 1, 2, list(range(25)))
    p.merge_poll_state(ALICE)


def registration_after_signup(m):
    p = m.InfimumPallet()
    p.register_as_coordinator(ALICE, fx.COORD_PK, FIX["vkeys"])
    p.create_poll(ALICE, 12, 12, 10, 2, 1, 1, 2, list(range(25)))
    p.run_to_block(13)
    p.register_as_participant(BOB, 0, fx.PARTICIPANTS[0])


def depth_beyond_runtime_bound(m):
    p = m.InfimumPallet(m.RuntimeConfig(max_poll_registrations=1024,
                                        max_poll_interactions=1024))
    p.register_as_coordinator(ALICE, fx.COORD_PK, FIX["vkeys"])
    p.create_poll(ALICE, 12, 12, 11, 2, 1, 1, 2, list(range(25)))


def corrupted_proof(m):
    p = m.InfimumPallet()
    _setup_poll(p)
    bad = dict(FIX["get_proof"]["process"])
    bad["pi_c"] = FIX["get_proof"]["tally"]["pi_c"]  # valid point, wrong proof
    p.commit_outcome(ALICE, [(bad, bytes(
        FIX["get_proof"]["process_commitment"]))])


def wrong_commitment(m):
    p = m.InfimumPallet()
    _setup_poll(p)
    p.commit_outcome(ALICE, [(FIX["get_proof"]["process"],
                              (123456789).to_bytes(32, "big"))])


def empty_commit(m):
    p = m.InfimumPallet()
    _setup_poll(p)
    p.commit_outcome(ALICE, [])


ERRORS = {
    already_registered: "CoordinatorAlreadyRegistered",
    not_registered: "CoordinatorNotRegistered",
    malformed_vkeys: "MalformedKeys",
    merge_during_registration: "PollRegistrationInProgress",
    registration_after_signup: "PollRegistrationHasEnded",
    depth_beyond_runtime_bound: "PollConfigInvalid",
    corrupted_proof: "MalformedProof",
    wrong_commitment: "MalformedProof",
    empty_commit: "MalformedInput",
}


@pytest.mark.parametrize("case", ERRORS, ids=lambda f: f.__name__)
def test_pallet_error_matches_reference(case):
    raised = []
    for name in PACKAGES:
        m = importlib.import_module(f"{name}.pallet")
        with pytest.raises(m.PalletError) as e:
            case(m)
        assert type(e.value.error) is m.Error
        raised.append((e.value.error.name, e.value.reason))
    assert raised[0] == raised[1]
    assert raised[0][0] == ERRORS[case]


def test_reference_proofs_accepted_by_port_pallet():
    """The reference's real process and tally proofs commit through the
    port's pallet (the port's verify) as through the reference's."""
    states = []
    for name in PACKAGES:
        p = importlib.import_module(f"{name}.pallet").InfimumPallet()
        _setup_poll(p)
        p.commit_outcome(ALICE, [
            (FIX["get_proof"]["process"],
             bytes(FIX["get_proof"]["process_commitment"])),
            (FIX["get_proof"]["tally"],
             bytes(FIX["get_proof"]["tally_commitment"]))])
        c = p.polls[0].commitment
        states.append((c.process, c.tally, [e.name for e in p.events]))
    assert states[0] == states[1]
    assert states[0][0][0] == 1 and states[0][1][0] == 1


def test_typed_dispatcher_matches_reference():
    out = []
    for name in PACKAGES:
        d = importlib.import_module(f"{name}.pallet.dispatch")
        m = importlib.import_module(f"{name}.pallet")
        p = m.InfimumPallet()
        got = [d.dispatch(p, ALICE, d.Extrinsic.REGISTER_AS_COORDINATOR,
                          public_key=fx.COORD_PK, vkeys=FIX["vkeys"]),
               d.dispatch(p, ALICE, d.Extrinsic.CREATE_POLL,
                          signup_period=12, voting_period=12,
                          registration_depth=10, interaction_depth=2,
                          process_subtree_depth=1, tally_subtree_depth=1,
                          vote_option_tree_depth=2,
                          vote_options=list(range(25)))]
        with pytest.raises(TypeError):
            d.dispatch(p, ALICE, d.Extrinsic.CREATE_POLL, signup_period=12)
        p.run_to_block(2)
        got.append(d.dispatch(p, BOB, d.Extrinsic.REGISTER_AS_PARTICIPANT,
                              poll_id=0, public_key=fx.PARTICIPANTS[0]))
        with pytest.raises(m.PalletError) as e:
            d.dispatch(p, ALICE, d.Extrinsic.NULLIFY_POLL)
        out.append(([[(ev.name, ev.data) for ev in r.events] for r in got],
                    e.value.error.name))
    assert out[0] == out[1]


def test_pallet_verifies_with_the_ports_verify():
    from infimum_tpu_torch.groth16 import groth16
    from infimum_tpu_torch.pallet import chain

    assert chain.groth16_verify is groth16.verify
    assert chain.deserialize_proof(FIX["get_proof"]["process"]).__class__ \
        is groth16.Proof
