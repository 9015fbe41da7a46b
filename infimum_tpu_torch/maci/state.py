# Copied from infimum_tpu/maci/state.py; the port keeps its own host layers.
"""The poll state machine: registrations, interactions, merges, commitments,
public signals, and outcome verification.

This is the chain-free equivalent of the reference pallet's poll provider
(reference: pallet/src/poll/provider.rs) — same hashes, same trees, same
public-input computation, so proofs generated by this stack chain onto the same
commitment values the on-chain verifier derives from storage.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hash.poseidon_host import poseidon
from ..tree.imt import AmortizedIMT, MerkleTreeError
from ..tree.zeros import empty_ballot_root

VOTE_TREE_ARITY = 5


@dataclass
class PollConfig:
    # reference: pallet/src/poll/config.rs:7-32
    signup_period: int
    voting_period: int
    registration_depth: int
    interaction_depth: int
    process_subtree_depth: int
    tally_subtree_depth: int
    vote_option_tree_depth: int
    vote_options: list[int]
    max_registrations: int = 65536
    max_interactions: int = 65536


@dataclass
class Commitment:
    # (index, value) cursors; reference: pallet/src/poll/coordinator.rs Commitment
    process: tuple[int, int] = (0, 0)
    tally: tuple[int, int] = (0, 0)
    expected_process: int = 0
    expected_tally: int = 0


@dataclass
class PollOutcome:
    # reference: pallet/src/poll/poll.rs PollOutcome
    tally_results: list[int]
    tally_result_proofs: list[list[list[int]]]
    total_spent: int
    total_spent_salt: int
    tally_result_salt: int
    new_results_commitment: int
    spent_votes_hash: int


@dataclass
class Poll:
    index: int
    created_at: int
    config: PollConfig
    registrations: AmortizedIMT = field(init=False)
    interactions: AmortizedIMT = field(init=False)
    commitment: Commitment = field(default_factory=Commitment)
    outcome: int | None = None
    tombstone: bool = False

    def __post_init__(self):
        # reference: pallet/src/poll/state.rs:40-67 — registration tree is
        # binary and pre-seeded with the blank state leaf; interactions quinary.
        self.registrations = AmortizedIMT.new(
            2, self.config.registration_depth, zero_seed=True
        )
        self.interactions = AmortizedIMT.new(
            5, self.config.interaction_depth, zero_seed=False
        )

    # -- periods (reference: provider.rs:340-393) ------------------------------

    def is_registration_period(self, now: int) -> bool:
        return self.created_at <= now < self.created_at + self.config.signup_period

    def is_voting_period(self, now: int) -> bool:
        start = self.created_at + self.config.signup_period
        return start <= now < start + self.config.voting_period

    def voting_period_end(self) -> int:
        return self.created_at + self.config.signup_period + self.config.voting_period

    def is_over(self, now: int) -> bool:
        return now > self.voting_period_end()

    def is_merged(self) -> bool:
        return self.registrations.root is not None and self.interactions.root is not None

    def is_proven(self) -> bool:
        c = self.commitment
        return (
            c.process[0] == c.expected_process and c.tally[0] == c.expected_tally
        )

    def is_fulfilled(self) -> bool:
        return self.outcome is not None or self.tombstone

    def nullify(self):
        self.tombstone = True

    def registration_limit_reached(self) -> bool:
        return self.registrations.count >= self.config.max_registrations - 1

    def interaction_limit_reached(self) -> bool:
        return self.interactions.count >= self.config.max_interactions

    # -- state transitions -----------------------------------------------------

    def register_participant(self, public_key: tuple[int, int], timestamp: int) -> int:
        """Leaf = Poseidon4(pubX, pubY, 1, timestamp); reference: provider.rs:218-241."""
        leaf = poseidon([public_key[0], public_key[1], 1, timestamp])
        return self.registrations.insert(leaf)

    def consume_interaction(self, public_key: tuple[int, int], data: list[int]) -> int:
        """Leaf = Poseidon4(P5(data[0..5]), P5(data[5..10]), pubX, pubY);
        reference: provider.rs:243-287."""
        assert len(data) == 10
        left = poseidon(list(data[:5]))
        right = poseidon(list(data[5:]))
        leaf = poseidon([left, right, public_key[0], public_key[1]])
        return self.interactions.insert(leaf)

    def merge_registrations(self) -> None:
        """Merge (stopping at first root) and seed the process commitment chain:
        Poseidon3(root, EMPTY_BALLOT_ROOTS[1], 0); reference: provider.rs:289-311.

        NB the reference hardcodes ballot-root index 1 (vote option depth 2)."""
        self.registrations.merge(False)
        if self.registrations.root is None:
            raise MerkleTreeError(MerkleTreeError.MERGE_FAILED)
        commitment = poseidon(
            [self.registrations.root, empty_ballot_root(1), 0]
        )
        self.commitment.process = (0, commitment)

    def merge_interactions(self) -> None:
        """Merge to full depth and record expected proof counts;
        reference: provider.rs:313-327."""
        self.interactions.merge(True)
        process_batch = self.interactions.arity ** self.config.process_subtree_depth
        extra = 1 if self.interactions.count % process_batch > 0 else 0
        self.commitment.expected_process = (
            self.interactions.count // process_batch + extra
        )
        tally_batch = self.registrations.arity ** self.config.tally_subtree_depth
        self.commitment.expected_tally = 1 + self.registrations.count // tally_batch

    # -- proof plumbing (reference: provider.rs:141-216) -----------------------

    def prepare_public_inputs(
        self, coordinator_public_key: tuple[int, int], new_commitment: int
    ) -> tuple[str, list[int], Commitment]:
        """Returns (circuit kind, public inputs, advanced commitment cursors)."""
        c = self.commitment
        message_batch_size = (
            self.interactions.arity ** self.config.process_subtree_depth
        )
        current_batch_index = self.interactions.count
        if current_batch_index > 0:
            r = self.interactions.count % message_batch_size
            current_batch_index -= message_batch_size if r == 0 else r
        proof_index = c.process[0]
        index_offset = proof_index * message_batch_size

        if index_offset <= current_batch_index:
            # process-messages public signals (9)
            coord_hash = poseidon(list(coordinator_public_key))
            if self.interactions.root is None:
                raise ValueError("interactions not merged")
            current_batch_index -= index_offset
            end_batch_index = min(
                current_batch_index + message_batch_size, self.interactions.count
            )
            inputs = [
                self.registrations.count + 1,
                self.voting_period_end(),
                self.interactions.root,
                self.registrations.depth,
                end_batch_index,
                current_batch_index,
                coord_hash,
                c.process[1],
                new_commitment,
            ]
            new_c = Commitment(
                process=(proof_index + 1, new_commitment),
                tally=c.tally,
                expected_process=c.expected_process,
                expected_tally=c.expected_tally,
            )
            return ("process", inputs, new_c)
        else:
            # tally public signals (5)
            proof_index = c.tally[0]
            batch_size = self.registrations.arity ** self.config.tally_subtree_depth
            current_batch_index = proof_index * batch_size
            if current_batch_index >= self.registrations.count + 1:
                raise ValueError("no more tally batches")
            inputs = [
                c.process[1],
                c.tally[1],
                new_commitment,
                current_batch_index,
                self.registrations.count + 1,
            ]
            new_c = Commitment(
                process=c.process,
                tally=(proof_index + 1, new_commitment),
                expected_process=c.expected_process,
                expected_tally=c.expected_tally,
            )
            return ("tally", inputs, new_c)

    def commit(self, new_commitment: Commitment) -> None:
        self.commitment = new_commitment

    # -- outcome (reference: provider.rs:76-139) -------------------------------

    def verify_outcome(self, outcome: PollOutcome) -> int | None:
        if not self.is_proven():
            return None
        outcome_index = 0
        max_tally = 0
        for option_index in range(len(self.config.vote_options)):
            if option_index >= len(outcome.tally_results):
                return None
            tally_result = outcome.tally_results[option_index]
            path = outcome.tally_result_proofs[option_index]
            root = compute_merkle_root_from_path(
                self.config.vote_option_tree_depth, option_index, tally_result, path
            )
            h = poseidon([root, outcome.tally_result_salt])
            h = poseidon([h, outcome.spent_votes_hash])
            if h != self.commitment.tally[1]:
                return None
            if tally_result > max_tally:
                outcome_index = option_index
                max_tally = tally_result
        h = poseidon([outcome.total_spent, outcome.total_spent_salt])
        h = poseidon([outcome.new_results_commitment, h])
        if h != self.commitment.tally[1]:
            return None
        return outcome_index


def compute_merkle_root_from_path(
    depth: int, index: int, leaf: int, path: list[list[int]]
) -> int:
    """Quinary inclusion-path root; reference: provider.rs:396-436."""
    idx = index
    position = idx % VOTE_TREE_ARITY
    current = leaf
    for i in range(depth):
        level = []
        for j in range(VOTE_TREE_ARITY):
            if j == position:
                level.append(current)
            else:
                k = j - 1 if j > position else j
                level.append(path[i][k])
        current = poseidon(level)
        idx //= VOTE_TREE_ARITY
        position = idx % VOTE_TREE_ARITY
    return current
