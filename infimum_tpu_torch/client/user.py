# Copied from infimum_tpu/client/user.py; prove_poll_results proves on `device`.
"""User roles: Coordinator and Participant, mirroring the reference CLI's
user classes (cli/src/user/user.ts, coordinator.ts, participant.ts) against
the chain-free pallet equivalent.

The reference signs extrinsics over websocket RPC; here the pallet is
in-process, so `origin` is an opaque account id and the extrinsic dispatcher
(cli/src/extrinsic.ts:153-203) collapses to direct method calls — every
argument is serialized through the same byte contracts the pallet checks."""

from __future__ import annotations

import random

from ..hash.cipher import poseidon_encrypt
from ..hash.poseidon_host import poseidon
from ..maci.keys import Keypair
from ..maci.replay import pack_command
from .prover import ProverKeys, PollProver


class User:
    """Base user: a network account id + a MACI keypair for poll crypto
    (cli/src/user/user.ts:19-31)."""

    def __init__(self, origin, sk: int):
        self.origin = origin
        self.keypair = Keypair(sk=sk)

    @property
    def public_key(self) -> tuple[int, int]:
        return self.keypair.pub


class Coordinator(User):
    """Poll operator (cli/src/user/coordinator.ts:12-120): registers vkeys,
    creates/merges/nullifies polls, proves and commits outcomes."""

    def __init__(self, origin, sk: int, keys: ProverKeys):
        super().__init__(origin, sk)
        self.keys = keys

    def register(self, pallet):
        pallet.register_as_coordinator(
            self.origin, self.public_key, self.keys.vkeys())

    def rotate_keys(self, pallet, new_sk: int, keys: ProverKeys | None = None):
        self.keypair = Keypair(sk=new_sk)
        if keys is not None:
            self.keys = keys
        pallet.rotate_keys(self.origin, self.public_key, self.keys.vkeys())

    def create_poll(self, pallet, signup_period: int, voting_period: int):
        c = self.keys.process_circuit
        t = self.keys.tally_circuit
        return pallet.create_poll(
            self.origin, signup_period, voting_period,
            registration_depth=c.state_tree_depth,
            interaction_depth=c.msg_tree_depth,
            process_subtree_depth=c.msg_batch_depth,
            tally_subtree_depth=t.int_state_tree_depth,
            vote_option_tree_depth=c.vote_option_tree_depth,
            vote_options=list(range(5 ** c.vote_option_tree_depth)),
        )

    def merge_poll_state(self, pallet):
        pallet.merge_poll_state(self.origin)

    def nullify_poll(self, pallet):
        pallet.nullify_poll(self.origin)

    def prove_poll_results(self, pallet, poll_id: int,
                           rng: random.Random | None = None, device="cuda"):
        """The reference e2e's provePollResults + commitOutcome
        (e2e.test.ts:124-126): replay events, prove all batches on
        `device`, submit."""
        poll = pallet.polls[poll_id]
        prover = PollProver(self.keys, self.keypair, poll.config,
                            poll_end_timestamp=poll.voting_period_end(),
                            rng=rng, device=device)
        prover.ingest_events(pallet.events, poll_id)
        batches, outcome = prover.prove_poll_results()
        return pallet.commit_outcome(self.origin, batches, outcome)


class Participant(User):
    """Voter (cli/src/user/participant.ts:18-49)."""

    def register(self, pallet, poll_id: int):
        return pallet.register_as_participant(
            self.origin, poll_id, self.public_key)

    def vote(self, pallet, poll_id: int, coordinator_pub: tuple[int, int],
             state_index: int, vote_option: int, weight: int, nonce: int,
             salt: int | None = None, new_keypair: Keypair | None = None,
             eph_sk: int | None = None):
        """Build, sign, encrypt and submit one MACI message — the flow the
        reference runs through maci-domainobjs PCommand.sign/encrypt
        (e2e.test.ts:91-106): packed command -> EdDSA-Poseidon signature ->
        ECDH shared key with the coordinator -> Poseidon cipher."""
        rng = random.Random(f"{self.origin}/{state_index}/{nonce}/{vote_option}")
        salt = salt if salt is not None else rng.getrandbits(200)
        new_pub = (new_keypair or self.keypair).pub
        packed = pack_command(state_index, vote_option, weight, nonce,
                              poll_id, new_pub, salt)
        sig_r8, sig_s = self.keypair.sign(poseidon(packed))
        eph = Keypair(sk=eph_sk if eph_sk is not None else rng.getrandbits(250))
        shared = eph.ecdh(coordinator_pub)
        data = poseidon_encrypt(packed + [sig_r8[0], sig_r8[1], sig_s],
                                shared, 0)
        pallet.interact_with_poll(self.origin, poll_id, eph.pub, data)
        if new_keypair is not None:
            self.keypair = new_keypair
        return data, eph.pub
