# Copied from infimum_tpu/witness/process.py; the port keeps its own host layers.
"""Witness-input builder for the native ProcessMessages circuit.

Plays maci-core's `poll.processMessages()` role (reference
cli/src/utils.ts:104-126): walks message batches from LAST to FIRST, and for
each batch records, per message in reverse order, the pre-application state
leaf / ballot / vote-weight and their Merkle paths, applying the message
between recordings. Commitments chain exactly as the pallet expects
(initial salt 0, Poseidon3(stateRoot, ballotRoot, salt) thereafter)."""

from __future__ import annotations

from ..ff.bn254 import FR_MOD
from ..hash.poseidon_host import poseidon
from ..curve.babyjubjub import BASE8
from ..tree.full import FullTree
from ..tree.zeros import blank_state_leaf, quinary_zero_root
from ..maci.replay import MaciReplay, decrypt_message, MSG_WORDS
from ..circuits.process import ProcessCircuit

P = FR_MOD

PAD_MSG = [0] * MSG_WORDS
PAD_ENC_PUB = BASE8


class ProcessWitnessBuilder:
    def __init__(self, circuit: ProcessCircuit, replay: MaciReplay):
        assert circuit.state_tree_depth == replay.state_tree_depth
        assert circuit.msg_tree_depth == replay.msg_tree_depth
        assert circuit.msg_batch_depth == replay.msg_batch_depth
        assert circuit.vote_option_tree_depth == replay.vote_option_tree_depth
        self.c = circuit
        self.r = replay
        if replay.ballots is None:
            replay.ballots = replay.initial_ballots()
        d = replay.vote_option_tree_depth
        self.state_tree = replay.state_tree()
        zero_ballot = poseidon([0, quinary_zero_root(d)])
        self.ballot_tree = FullTree(
            2, replay.state_tree_depth, zero_ballot,
            [b.hash(d) for b in replay.ballots],
        )
        self.msg_tree = replay.message_tree()
        self.sb_salt = 0
        self.sb_commitment = poseidon([
            self.state_tree.root, self.ballot_tree.root, 0,
        ])

    def batches(self, rng):
        """Yield (values, meta) per proof, batches last -> first."""
        bs = self.c.batch_size
        n = len(self.r.messages)
        nbatches = max(1, -(-n // bs))
        for b in range(nbatches - 1, -1, -1):
            yield self._one_batch(b, rng)

    def _one_batch(self, b: int, rng):
        c, r = self.c, self.r
        bs = c.batch_size
        std = c.state_tree_depth
        vod = c.vote_option_tree_depth
        n = len(r.messages)
        index = b * bs
        batch_end = min(n, index + bs)

        msgs, enc_pubs = [], []
        for i in range(index, index + bs):
            if i < n:
                data, ep = r.messages[i]
            else:
                data, ep = PAD_MSG, PAD_ENC_PUB
            msgs.append(list(data))
            enc_pubs.append([ep[0], ep[1]])

        sub_elems, _ = self.msg_tree.path(index, from_level=c.msg_batch_depth)

        state_leaves, state_paths = [], []
        ballots_in, ballot_paths = [], []
        weights, weight_paths = [], []
        slot = [None] * bs

        actual = r.actual_state_tree_depth
        current_state_root = self.state_tree.root
        current_ballot_root = self.ballot_tree.root
        current_sb = self.sb_commitment
        current_salt = self.sb_salt

        for i in range(bs - 1, -1, -1):
            cmd = decrypt_message(msgs[i], r.coordinator,
                                  tuple(enc_pubs[i]))
            si_ok = cmd.state_index < r.num_signups
            si = cmd.state_index if si_ok else 0
            vo_ok = cmd.vote_option_index < c.num_vote_options
            vo = cmd.vote_option_index if vo_ok else 0

            leaf = r.leaves[si] if si < len(r.leaves) else None
            if leaf is None:
                from ..maci.replay import pad_leaf
                leaf = pad_leaf()
            ballot = (r.ballots[si] if si < len(r.ballots) else None)
            if ballot is None:
                from ..maci.replay import ReplayBallot
                ballot = ReplayBallot(nonce=0, votes=[0] * c.num_vote_options)

            # record pre-application values + paths
            st_elems, _ = self.state_tree.path(si)
            st_elems = [e[0] for e in st_elems] + [0] * (std - actual)
            bl_elems, _ = self.ballot_tree.path(si)
            bl_elems = [e[0] for e in bl_elems]
            vt = FullTree(5, vod, 0, ballot.votes)
            w_elems, _ = vt.path(vo)

            slot[i] = dict(
                leaf=[leaf.pub[0], leaf.pub[1], leaf.voice_credits,
                      leaf.timestamp],
                state_path=st_elems,
                ballot=[ballot.nonce, ballot.vo_root(vod)],
                ballot_path=bl_elems,
                weight=ballot.votes[vo],
                weight_path=w_elems,
            )

            # apply (mutates replay leaves/ballots), then refresh live trees
            r.apply_message(cmd)
            if si < len(r.leaves):
                self.state_tree.update(si, r.leaves[si].hash())
                self.ballot_tree.update(si, r.ballots[si].hash(vod))

        new_salt = rng.randrange(P)
        new_sb = poseidon([self.state_tree.root, self.ballot_tree.root,
                           new_salt])

        values = {
            "numSignUps": r.num_signups,
            "pollEndTimestamp": r.poll_end_timestamp,
            "msgRoot": self.msg_tree.root,
            "actualStateTreeDepth": actual,
            "batchEndIndex": batch_end,
            "index": index,
            "coordinatorPublicKeyHash": poseidon(list(r.coordinator.pub)),
            "currentSbCommitment": current_sb,
            "newSbCommitment": new_sb,
            "msgs": msgs,
            "msgSubrootPathElements": sub_elems,
            "coordPrivKey": self._coord_scalar(),
            "encPubKeys": enc_pubs,
            "currentStateRoot": current_state_root,
            "currentStateLeaves": [slot[i]["leaf"] for i in range(bs)],
            "currentStateLeavesPathElements":
                [slot[i]["state_path"] for i in range(bs)],
            "currentSbSalt": current_salt,
            "newSbSalt": new_salt,
            "currentBallotRoot": current_ballot_root,
            "currentBallots": [slot[i]["ballot"] for i in range(bs)],
            "currentBallotsPathElements":
                [slot[i]["ballot_path"] for i in range(bs)],
            "currentVoteWeights": [slot[i]["weight"] for i in range(bs)],
            "currentVoteWeightsPathElements":
                [slot[i]["weight_path"] for i in range(bs)],
        }
        meta = {
            "new_commitment": new_sb,
            "new_salt": new_salt,
            "state_root": self.state_tree.root,
            "ballot_root": self.ballot_tree.root,
        }
        self.sb_salt = new_salt
        self.sb_commitment = new_sb
        return values, meta

    def _coord_scalar(self) -> int:
        from ..maci.keys import format_priv_key

        return format_priv_key(self.r.coordinator.sk)
