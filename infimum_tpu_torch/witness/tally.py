# Copied from infimum_tpu/witness/tally.py; the port keeps its own host layers.
"""Witness-input builder for the native TallyVotes circuit.

Plays the role maci-core's `poll.tallyVotesNonQv()` plays for the reference
CLI (cli/src/utils.ts:104-126): given the post-processing ballot set, emit
per-batch circuit inputs and the chained tally commitments
(tally commitment = Poseidon2(Poseidon2(resultsRoot, salt),
Poseidon2(spent, salt)), reference circuits/tally-votes.circom:193-228)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ff.bn254 import FR_MOD
from ..hash.poseidon_host import poseidon
from ..tree.full import FullTree
from ..tree.zeros import quinary_zero_root
from ..circuits.tally import TallyCircuit

P = FR_MOD


@dataclass
class Ballot:
    nonce: int = 0
    votes: list = field(default_factory=list)

    def vote_option_root(self, vote_option_tree_depth: int) -> int:
        return FullTree(5, vote_option_tree_depth, 0, self.votes).root

    def hash(self, vote_option_tree_depth: int) -> int:
        return poseidon([self.nonce, self.vote_option_root(vote_option_tree_depth)])


def blank_ballot(vote_option_tree_depth: int) -> Ballot:
    return Ballot(nonce=0, votes=[])


def results_commitment(results: list[int], salt: int, depth: int) -> int:
    return poseidon([FullTree(5, depth, 0, results).root, salt])


def tally_commitment(results: list[int], results_salt: int,
                     spent: int, spent_salt: int, depth: int) -> int:
    return poseidon([
        results_commitment(results, results_salt, depth),
        poseidon([spent, spent_salt]),
    ])


class TallyWitnessBuilder:
    """Drains tally batches like maci-core's tallyVotesNonQv loop."""

    def __init__(self, circuit: TallyCircuit, state_root: int, sb_salt: int,
                 ballots: list[Ballot], num_signups: int):
        self.c = circuit
        self.state_root = state_root
        self.sb_salt = sb_salt
        self.ballots = ballots
        self.num_signups = num_signups
        d = circuit.vote_option_tree_depth
        zero_leaf = poseidon([0, quinary_zero_root(d)])
        self.ballot_tree = FullTree(
            2, circuit.state_tree_depth, zero_leaf,
            [b.hash(d) for b in ballots],
        )
        self.ballot_root = self.ballot_tree.root
        self.sb_commitment = poseidon([state_root, self.ballot_root, sb_salt])
        self.results = [0] * circuit.num_vote_options
        self.spent = 0
        self.tally_commitment = 0
        self.batch = 0

    @property
    def num_batches(self) -> int:
        """ceil(num_signups / batch) with num_signups counting the blank
        leaf, i.e. pallet count+1 — identical to the pallet's expected_tally
        = 1 + count // batch (provider.rs:323-324)."""
        n = max(1, self.num_signups)
        return -(-n // self.c.batch_size)

    def batch_inputs(self, rng) -> tuple[dict, dict]:
        """Inputs for the next batch. Returns (circuit_values, meta) and
        advances the running tally; meta carries the new commitment/salts."""
        c = self.c
        bs, nvo, d = c.batch_size, c.num_vote_options, c.vote_option_tree_depth
        index = self.batch * bs
        batch_ballots = [
            self.ballots[i] if i < len(self.ballots) else blank_ballot(d)
            for i in range(index, index + bs)
        ]
        votes = [
            [(b.votes[j] if j < len(b.votes) else 0) for j in range(nvo)]
            for b in batch_ballots
        ]
        elements, _ = self.ballot_tree.path(index, from_level=c.int_state_tree_depth)
        path = [e[0] for e in elements]

        cur_results = list(self.results)
        cur_spent = self.spent
        cur_commitment = self.tally_commitment
        # the circuit computes newResults = votes + currentResults * notFirst
        new_results = [
            (cur_results[i] if index != 0 else 0) + sum(v[i] for v in votes)
            for i in range(nvo)
        ]
        new_spent = (cur_spent if index != 0 else 0) + sum(sum(v) for v in votes)

        cur_results_salt = getattr(self, "_results_salt", 0)
        cur_spent_salt = getattr(self, "_spent_salt", 0)
        new_results_salt = rng.randrange(P)
        new_spent_salt = rng.randrange(P)
        new_commitment = tally_commitment(
            new_results, new_results_salt, new_spent, new_spent_salt, d
        )

        values = {
            "sbCommitment": self.sb_commitment,
            "currentTallyCommitment": cur_commitment,
            "newTallyCommitment": new_commitment,
            "index": index,
            "numSignUps": self.num_signups,
            "stateRoot": self.state_root,
            "ballotRoot": self.ballot_root,
            "sbSalt": self.sb_salt,
            "ballots": [[b.nonce, b.vote_option_root(d)] for b in batch_ballots],
            "ballotPathElements": path,
            "votes": votes,
            "currentResults": cur_results,
            "currentResultsRootSalt": cur_results_salt,
            "currentSpentVoiceCreditSubtotal": cur_spent,
            "currentSpentVoiceCreditSubtotalSalt": cur_spent_salt,
            "newResultsRootSalt": new_results_salt,
            "newSpentVoiceCreditSubtotalSalt": new_spent_salt,
        }
        meta = {
            "new_commitment": new_commitment,
            "results": new_results,
            "spent": new_spent,
            "results_salt": new_results_salt,
            "spent_salt": new_spent_salt,
        }
        # advance
        self.results = new_results
        self.spent = new_spent
        self.tally_commitment = new_commitment
        self._results_salt = new_results_salt
        self._spent_salt = new_spent_salt
        self.batch += 1
        return values, meta
