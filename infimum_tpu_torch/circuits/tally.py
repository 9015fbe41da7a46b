# Copied from infimum_tpu/circuits/tally.py; the port keeps its own host layers.
# The constraint system's build is the span `setup.circuit`.
"""Native TallyVotes circuit: statement-equivalent to the reference's
TallyVotes(stateTreeDepth, intStateTreeDepth, voteOptionTreeDepth)
(circuits/tally-votes.circom:14-152, instantiated (10,1,2) by
circuits/main-tally.circom:4).

Public inputs, in the order the pallet supplies them
(pallet/src/poll/provider.rs:205-209, = circom signal declaration order):
  [sbCommitment, currentTallyCommitment, newTallyCommitment, index, numSignUps]

The statement: a batch of 2^intStateTreeDepth ballots at `index` is included
under ballotRoot (with sbCommitment = Poseidon3(stateRoot, ballotRoot,
sbSalt)), each ballot's vote tree matches its declared root, and the new
tally commitment correctly accumulates the batch's votes and spent credits
on top of the previous commitment chain.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ff.bn254 import FR_MOD, fr_inv
from ..groth16.r1cs import ConstraintSystem, LC
from ..utils.profiling import span
from .gadgets import (
    poseidon_gadget,
    check_root_binary,
    check_root_quinary,
    merkle_inclusion_binary,
    less_eq_than,
)

P = FR_MOD


@dataclass
class TallyCircuit:
    state_tree_depth: int = 10
    int_state_tree_depth: int = 1
    vote_option_tree_depth: int = 2
    build: bool = True  # False: dims-only (witness building without the CS)

    def __post_init__(self):
        assert 0 < self.int_state_tree_depth < self.state_tree_depth
        assert self.vote_option_tree_depth > 0
        self.batch_size = 2 ** self.int_state_tree_depth
        self.num_vote_options = 5 ** self.vote_option_tree_depth
        self.k = self.state_tree_depth - self.int_state_tree_depth
        if self.build:
            with span("setup.circuit"):
                self._build()

    def _build(self):
        cs = ConstraintSystem()
        bs, nvo, k = self.batch_size, self.num_vote_options, self.k

        # public inputs (provider ordering)
        sb_commitment = cs.alloc_public()
        current_tally = cs.alloc_public()
        new_tally = cs.alloc_public()
        index = cs.alloc_public()
        num_signups = cs.alloc_public()

        # private witness
        state_root = cs.alloc()
        ballot_root = cs.alloc()
        sb_salt = cs.alloc()
        ballots = [[cs.alloc(), cs.alloc()] for _ in range(bs)]  # nonce, voRoot
        ballot_path = [cs.alloc() for _ in range(k)]
        votes = [[cs.alloc() for _ in range(nvo)] for _ in range(bs)]
        cur_results = [cs.alloc() for _ in range(nvo)]
        cur_results_salt = cs.alloc()
        cur_spent = cs.alloc()
        cur_spent_salt = cs.alloc()
        new_results_salt = cs.alloc()
        new_spent_salt = cs.alloc()

        self.inputs = {
            "sbCommitment": sb_commitment,
            "currentTallyCommitment": current_tally,
            "newTallyCommitment": new_tally,
            "index": index,
            "numSignUps": num_signups,
            "stateRoot": state_root,
            "ballotRoot": ballot_root,
            "sbSalt": sb_salt,
            "ballots": ballots,
            "ballotPathElements": ballot_path,
            "votes": votes,
            "currentResults": cur_results,
            "currentResultsRootSalt": cur_results_salt,
            "currentSpentVoiceCreditSubtotal": cur_spent,
            "currentSpentVoiceCreditSubtotalSalt": cur_spent_salt,
            "newResultsRootSalt": new_results_salt,
            "newSpentVoiceCreditSubtotalSalt": new_spent_salt,
        }
        V = LC.var

        # 1. sbCommitment check (tally-votes.circom:78-79)
        cs.enforce_zero(
            poseidon_gadget(cs, [V(state_root), V(ballot_root), V(sb_salt)])
            - V(sb_commitment)
        )

        # 2. index <= numSignUps over 50 bits (tally-votes.circom:83-84)
        cs.enforce_zero(
            less_eq_than(cs, V(index), V(num_signups), 50) - LC.const(1)
        )

        # 3-4. ballot subroot + inclusion under ballotRoot (:87-102)
        hashed = [
            poseidon_gadget(cs, [V(b[0]), V(b[1])]) for b in ballots
        ]
        subroot = check_root_binary(cs, hashed)
        # path indices = bits of index / batchSize (field-exact division)
        q = V(index).scale(fr_inv(self.batch_size))
        path_idx = cs.num2bits(q, k)
        root = merkle_inclusion_binary(
            cs, subroot, path_idx, [V(e) for e in ballot_path]
        )
        cs.enforce_zero(root - V(ballot_root))

        # 5. per-ballot vote tree root check (:105-109)
        for i in range(bs):
            vroot = check_root_quinary(cs, [V(x) for x in votes[i]])
            cs.enforce_zero(vroot - V(ballots[i][1]))

        # 6. batch accumulation (:112-136)
        is_first = cs.is_zero(V(index))
        not_first = cs.is_zero(is_first)
        new_results = []
        for i in range(nvo):
            carried = cs.mul(V(cur_results[i]), not_first)
            total = sum((V(votes[j][i]) for j in range(bs)), carried)
            new_results.append(total)
        carried_spent = cs.mul(V(cur_spent), not_first)
        new_spent = sum(
            (V(votes[i][j]) for i in range(bs) for j in range(nvo)),
            carried_spent,
        )

        # 7. commitment chain (ResultCommitmentVerifierNonQv, :159-228)
        cur_root = check_root_quinary(cs, [V(x) for x in cur_results])
        cur_rc = poseidon_gadget(cs, [cur_root, V(cur_results_salt)])
        cur_sc = poseidon_gadget(cs, [V(cur_spent), V(cur_spent_salt)])
        cur_commit = poseidon_gadget(cs, [cur_rc, cur_sc])
        hz = cs.mul(not_first, cur_commit)
        cs.enforce_zero(hz - V(current_tally))

        new_root = check_root_quinary(cs, new_results)
        new_rc = poseidon_gadget(cs, [new_root, V(new_results_salt)])
        new_sc = poseidon_gadget(cs, [new_spent, V(new_spent_salt)])
        new_commit = poseidon_gadget(cs, [new_rc, new_sc])
        cs.enforce_zero(new_commit - V(new_tally))

        self.cs = cs

    # -- witness assembly -----------------------------------------------------

    def assignment(self, values: dict) -> list[int]:
        """values keyed like self.inputs (same nesting) -> full witness."""
        flat = {}

        def bind(idx, val):
            if isinstance(idx, list):
                assert len(idx) == len(val), "input shape mismatch"
                for i2, v2 in zip(idx, val):
                    bind(i2, v2)
            else:
                flat[idx] = val % P

        for name, idx in self.inputs.items():
            bind(idx, values[name])
        return self.cs.compute_witness(flat)

    def public_inputs(self, values: dict) -> list[int]:
        return [
            values["sbCommitment"] % P,
            values["currentTallyCommitment"] % P,
            values["newTallyCommitment"] % P,
            values["index"] % P,
            values["numSignUps"] % P,
        ]
