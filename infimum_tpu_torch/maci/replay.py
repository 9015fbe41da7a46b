# Copied from infimum_tpu/maci/replay.py; the port keeps its own host layers.
"""Offchain MACI state replay: the maci-core equivalent the coordinator runs.

The reference CLI replays chain events through maci-core's `MaciState`/`Poll`
(cli/src/utils.ts:104-126, e2e flow cli/__tests__/e2e.test.ts:75-110) to
produce circuit inputs for each process/tally batch. This module implements
that state machine natively with the exact semantics of the circuits:

  - state tree: binary, leaf 0 = blank state leaf, users from index 1,
    leaf = Poseidon4(pubX, pubY, voiceCredits=1, timestamp)
    (pallet/src/poll/provider.rs:226-233)
  - message tree: quinary, leaf = Poseidon4(Poseidon5(d[0..5]),
    Poseidon5(d[5..10]), encPubX, encPubY) (provider.rs:243-287,
    circuits/utils/hashers.circom:39-78)
  - message decryption: ECDH -> Poseidon cipher (7 -> 9 words), command
    unpack of 5x50-bit fields (circuits/utils/message-to-command.circom)
  - validation: the 6 checks of MessageValidatorNonQv
    (circuits/utils/message-validator.circom:58-92)
  - application: reverse order within a batch, batches from last to first
    (circuits/process-messages.circom:228)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ff.bn254 import FR_MOD
from ..hash.poseidon_host import poseidon
from ..hash.cipher import poseidon_decrypt
from .keys import Keypair, verify as eddsa_verify
from ..tree.full import FullTree
from ..tree.zeros import (
    blank_state_leaf, PAD_KEY_X, PAD_KEY_Y,
    NOTHING_UP_MY_SLEEVE, quinary_zero_root,
)

P = FR_MOD
MSG_WORDS = 10
CIPHER_WORDS = 7


@dataclass
class StateLeaf:
    pub: tuple[int, int]
    voice_credits: int
    timestamp: int

    def hash(self) -> int:
        return poseidon([self.pub[0], self.pub[1],
                         self.voice_credits, self.timestamp])


def pad_leaf() -> StateLeaf:
    return StateLeaf(pub=(PAD_KEY_X, PAD_KEY_Y), voice_credits=0, timestamp=0)


@dataclass
class ReplayBallot:
    nonce: int
    votes: list[int]

    def vo_root(self, depth: int) -> int:
        return FullTree(5, depth, 0, self.votes).root

    def hash(self, depth: int) -> int:
        return poseidon([self.nonce, self.vo_root(depth)])


@dataclass
class Command:
    state_index: int
    new_pub: tuple[int, int]
    vote_option_index: int
    new_vote_weight: int
    nonce: int
    poll_id: int
    salt: int
    sig_r8: tuple[int, int]
    sig_s: int
    packed: list[int]


def pack_command(state_index, vote_option_index, new_vote_weight, nonce,
                 poll_id, new_pub, salt) -> list[int]:
    """4-word packed command, maci-crypto layout: word 0 packs 5x50-bit
    fields with stateIndex in the LOW bits (UnpackElement(5) reads segments
    most-significant first and message-to-command.circom:60-67 assigns
    out[4]=stateIndex ... out[0]=pollId)."""
    w0 = (state_index
          | (vote_option_index << 50)
          | (new_vote_weight << 100)
          | (nonce << 150)
          | (poll_id << 200))
    return [w0, new_pub[0], new_pub[1], salt]


def unpack_command_word(w0: int) -> tuple[int, int, int, int, int]:
    """-> (state_index, vote_option_index, new_vote_weight, nonce, poll_id).
    Bits above 250 are ignored (UnpackElement drops them)."""
    mask = (1 << 50) - 1
    return (w0 & mask, (w0 >> 50) & mask, (w0 >> 100) & mask,
            (w0 >> 150) & mask, (w0 >> 200) & mask)


def decrypt_message(data: list[int], coordinator: Keypair,
                    enc_pub: tuple[int, int]) -> Command:
    """MessageToCommand: ECDH shared key + Poseidon decrypt (nonce 0, no
    authentication check — invalid messages decrypt to garbage commands that
    fail validation, exactly as in the circuit)."""
    shared = coordinator.ecdh(enc_pub)
    dec = poseidon_decrypt(data[:MSG_WORDS], shared, 0, CIPHER_WORDS,
                           check=False)
    packed = [x % P for x in dec[:4]]
    si, vo, wt, nonce, pid = unpack_command_word(packed[0])
    return Command(
        state_index=si, new_pub=(packed[1], packed[2]),
        vote_option_index=vo, new_vote_weight=wt, nonce=nonce, poll_id=pid,
        salt=packed[3], sig_r8=(dec[4] % P, dec[5] % P), sig_s=dec[6] % P,
        packed=packed,
    )


@dataclass
class MaciReplay:
    """Coordinator-side poll replay, seeded from chain events."""

    state_tree_depth: int          # full/max state depth (registration_depth)
    msg_tree_depth: int            # interaction_depth
    msg_batch_depth: int           # process_subtree_depth
    vote_option_tree_depth: int
    coordinator: Keypair
    poll_end_timestamp: int

    leaves: list = field(default_factory=list)
    messages: list = field(default_factory=list)   # (data10, enc_pub)

    def __post_init__(self):
        self.leaves = [pad_leaf()]
        self.ballots = None

    # -- event ingestion ------------------------------------------------------

    def sign_up(self, pub: tuple[int, int], timestamp: int):
        self.leaves.append(StateLeaf(pub=pub, voice_credits=1,
                                     timestamp=timestamp))

    def publish(self, data: list[int], enc_pub: tuple[int, int]):
        assert len(data) == MSG_WORDS
        self.messages.append(([d % P for d in data], enc_pub))

    # -- trees ----------------------------------------------------------------

    @property
    def num_signups(self) -> int:
        return len(self.leaves)     # includes the blank leaf (pallet count+1)

    @property
    def actual_state_tree_depth(self) -> int:
        n = len(self.leaves)
        return max(1, (n - 1).bit_length())

    def state_tree(self) -> FullTree:
        return FullTree(2, self.actual_state_tree_depth, blank_state_leaf(),
                        [l.hash() for l in self.leaves])

    def message_tree(self) -> FullTree:
        leaves = [
            poseidon([poseidon(d[:5]), poseidon(d[5:10]), ep[0], ep[1]])
            for d, ep in self.messages
        ]
        return FullTree(5, self.msg_tree_depth, NOTHING_UP_MY_SLEEVE, leaves)

    def initial_ballots(self):
        return [
            ReplayBallot(nonce=0, votes=[0] * (5 ** self.vote_option_tree_depth))
            for _ in range(len(self.leaves))
        ]

    # -- message application (ProcessOneNonQv semantics) ----------------------

    def _is_valid(self, cmd: Command, leaf: StateLeaf, ballot: ReplayBallot,
                  current_weight: int) -> tuple[bool, bool, bool]:
        """-> (is_valid, state_index_valid, vote_option_valid)."""
        nvo = 5 ** self.vote_option_tree_depth
        si_ok = cmd.state_index < self.num_signups
        vo_ok = cmd.vote_option_index < nvo
        nonce_ok = ballot.nonce + 1 == cmd.nonce
        msg_hash = poseidon(cmd.packed)
        sig_ok = eddsa_verify(leaf.pub, msg_hash, (cmd.sig_r8, cmd.sig_s))
        ts_ok = leaf.timestamp <= self.poll_end_timestamp
        credits_ok = (current_weight + leaf.voice_credits
                      >= cmd.new_vote_weight)
        valid = all((si_ok, vo_ok, nonce_ok, sig_ok, ts_ok, credits_ok))
        return valid, si_ok, vo_ok

    def apply_message(self, cmd: Command):
        """Mutates leaves/ballots per StateLeafAndBallotTransformerNonQv."""
        si = cmd.state_index if cmd.state_index < self.num_signups else 0
        leaf = self.leaves[si]
        ballot = self.ballots[si]
        vo = (cmd.vote_option_index
              if cmd.vote_option_index < 5 ** self.vote_option_tree_depth
              else 0)
        current_weight = ballot.votes[vo]
        valid, _, _ = self._is_valid(cmd, leaf, ballot, current_weight)
        if valid:
            leaf.pub = cmd.new_pub
            leaf.voice_credits = (leaf.voice_credits + current_weight
                                  - cmd.new_vote_weight)
            ballot.nonce = cmd.nonce
            ballot.votes[vo] = cmd.new_vote_weight
        return valid

    def process_all(self):
        """Apply all messages (batches last->first, reverse order within each
        batch). Returns the per-application order of commands."""
        if self.ballots is None:
            self.ballots = self.initial_ballots()
        bs = 5 ** self.msg_batch_depth
        n = len(self.messages)
        order = []
        nbatches = max(1, -(-n // bs))
        for b in range(nbatches - 1, -1, -1):
            for i in range(min(bs * (b + 1), n) - 1, bs * b - 1, -1):
                data, enc_pub = self.messages[i]
                cmd = decrypt_message(data, self.coordinator, enc_pub)
                self.apply_message(cmd)
                order.append(i)
        return order

    # -- roots/commitments ----------------------------------------------------

    def ballot_tree(self) -> FullTree:
        """Ballot tree is ALWAYS at the full state tree depth (the circuits
        use the static stateTreeDepth for ballot paths and the pallet seeds
        the commitment with the depth-10 EMPTY_BALLOT_ROOTS,
        pallet/src/poll/zeroes.rs:73-79); only the STATE tree uses the
        organic actualStateTreeDepth."""
        d = self.vote_option_tree_depth
        zero = poseidon([0, quinary_zero_root(d)])
        return FullTree(2, self.state_tree_depth, zero,
                        [b.hash(d) for b in self.ballots])

    def sb_commitment(self, salt: int) -> int:
        return poseidon([self.state_tree().root, self.ballot_tree().root, salt])
