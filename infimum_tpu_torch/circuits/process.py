# Copied from infimum_tpu/circuits/process.py; the port keeps its own host layers.
# The constraint system's build is the span `setup.circuit`.
"""Native ProcessMessages circuit: statement-equivalent to the reference's
ProcessMessages(stateTreeDepth, msgTreeDepth, msgBatchDepth,
voteOptionTreeDepth) (circuits/process-messages.circom:18-286, instantiated
(10,2,1,2) by circuits/main-process.circom:4).

Public inputs in the order the pallet supplies them
(pallet/src/poll/provider.rs:179-187 = circom declaration order):
  [numSignUps, pollEndTimestamp, msgRoot, actualStateTreeDepth,
   batchEndIndex, index, coordinatorPublicKeyHash,
   currentSbCommitment, newSbCommitment]

The statement: the prover knows the coordinator's private key matching the
public key hash, the batch of messages at [index, batchEndIndex) under
msgRoot, and pre-state (state tree, ballot tree) matching
currentSbCommitment, such that decrypting and applying the batch in REVERSE
order (invalid messages as no-ops) yields newSbCommitment."""

from __future__ import annotations

from dataclasses import dataclass

from ..ff.bn254 import FR_MOD
from ..tree.zeros import NOTHING_UP_MY_SLEEVE
from ..groth16.r1cs import ConstraintSystem, LC
from ..utils.profiling import span
from .gadgets import (
    poseidon_gadget, less_than, less_eq_than, is_equal, mux1,
    num2bits_strict, merkle_inclusion_binary,
)
from .merkle_gadgets import (
    quin_inclusion, quin_generate_path_indices, binary_merkle_root_dynamic,
)
from .babyjubjub_gadget import scalar_mul_bits, fixed_base_mul_bits
from .cipher_gadget import poseidon_decrypt_gadget
from .eddsa_gadget import eddsa_poseidon_check

P = FR_MOD
MSG_WORDS = 10
CIPHER_WORDS = 7


@dataclass
class ProcessCircuit:
    state_tree_depth: int = 10
    msg_tree_depth: int = 2
    msg_batch_depth: int = 1
    vote_option_tree_depth: int = 2
    build: bool = True  # False: dims-only (witness building without the CS)

    def __post_init__(self):
        assert self.msg_tree_depth >= self.msg_batch_depth > 0
        self.batch_size = 5 ** self.msg_batch_depth
        self.num_vote_options = 5 ** self.vote_option_tree_depth
        if self.build:
            with span("setup.circuit"):
                self._build()

    def _alloc_grid(self, cs, *dims):
        if len(dims) == 1:
            return [cs.alloc() for _ in range(dims[0])]
        return [self._alloc_grid(cs, *dims[1:]) for _ in range(dims[0])]

    def _build(self):
        cs = ConstraintSystem()
        bs = self.batch_size
        std = self.state_tree_depth
        vod = self.vote_option_tree_depth
        ktop = self.msg_tree_depth - self.msg_batch_depth

        # public inputs (pallet ordering)
        num_signups = cs.alloc_public()
        poll_end = cs.alloc_public()
        msg_root = cs.alloc_public()
        actual_depth = cs.alloc_public()
        batch_end = cs.alloc_public()
        index = cs.alloc_public()
        coord_hash = cs.alloc_public()
        current_sb = cs.alloc_public()
        new_sb = cs.alloc_public()

        g = self._alloc_grid
        msgs = g(cs, bs, MSG_WORDS)
        msg_subroot_path = g(cs, ktop, 4)
        coord_priv = cs.alloc()
        enc_pubs = g(cs, bs, 2)
        current_state_root = cs.alloc()
        state_leaves = g(cs, bs, 4)
        state_paths = g(cs, bs, std)
        current_sb_salt = cs.alloc()
        new_sb_salt = cs.alloc()
        current_ballot_root = cs.alloc()
        ballots = g(cs, bs, 2)
        ballot_paths = g(cs, bs, std)
        vote_weights = g(cs, bs)
        weight_paths = g(cs, bs, vod, 4)

        self.inputs = {
            "numSignUps": num_signups,
            "pollEndTimestamp": poll_end,
            "msgRoot": msg_root,
            "actualStateTreeDepth": actual_depth,
            "batchEndIndex": batch_end,
            "index": index,
            "coordinatorPublicKeyHash": coord_hash,
            "currentSbCommitment": current_sb,
            "newSbCommitment": new_sb,
            "msgs": msgs,
            "msgSubrootPathElements": msg_subroot_path,
            "coordPrivKey": coord_priv,
            "encPubKeys": enc_pubs,
            "currentStateRoot": current_state_root,
            "currentStateLeaves": state_leaves,
            "currentStateLeavesPathElements": state_paths,
            "currentSbSalt": current_sb_salt,
            "newSbSalt": new_sb_salt,
            "currentBallotRoot": current_ballot_root,
            "currentBallots": ballots,
            "currentBallotsPathElements": ballot_paths,
            "currentVoteWeights": vote_weights,
            "currentVoteWeightsPathElements": weight_paths,
        }
        V = LC.var

        cs.mark("sb_commitment")
        # sb commitment check (process-messages.circom:115-116)
        cs.enforce_zero(
            poseidon_gadget(cs, [V(current_state_root),
                                 V(current_ballot_root),
                                 V(current_sb_salt)]) - V(current_sb)
        )
        # numSignUps <= 2^stateTreeDepth (:126-127)
        cs.enforce_zero(
            less_eq_than(cs, V(num_signups), LC.const(2 ** std), 32)
            - LC.const(1)
        )

        cs.mark("msg_hash")
        # message hashing + zero-padding mux (:130-146)
        leaves = []
        for i in range(bs):
            h1 = poseidon_gadget(cs, [V(m) for m in msgs[i][:5]])
            h2 = poseidon_gadget(cs, [V(m) for m in msgs[i][5:10]])
            mh = poseidon_gadget(cs, [h1, h2, V(enc_pubs[i][0]),
                                      V(enc_pubs[i][1])])
            in_batch = less_than(cs, V(index) + LC.const(i), V(batch_end), 32)
            leaves.append(mux1(cs, in_batch,
                               LC.const(NOTHING_UP_MY_SLEEVE), mh))

        cs.mark("msg_subroot")
        # batch subroot + membership under msgRoot (:148-175)
        level = leaves
        while len(level) > 1:
            level = [poseidon_gadget(cs, level[j : j + 5])
                     for j in range(0, len(level), 5)]
        subroot = level[0]
        msg_digits = quin_generate_path_indices(cs, V(index),
                                                self.msg_tree_depth)
        computed_root = quin_inclusion(
            cs, subroot, msg_digits[self.msg_batch_depth:],
            [[V(e) for e in lvl] for lvl in msg_subroot_path],
        )
        cs.enforce_zero(computed_root - V(msg_root))

        cs.mark("coord_key")
        # coordinator key knowledge (:184-186); formatted BabyJubJub keys
        # live in [2^251, 2^252) — circomlib PrivToPubKey uses 253 bits
        coord_bits = cs.num2bits(V(coord_priv), 253)
        derived = fixed_base_mul_bits(cs, coord_bits)
        cs.enforce_zero(
            poseidon_gadget(cs, [derived[0], derived[1]]) - V(coord_hash)
        )

        cs.mark("decrypt")
        # decrypt all messages (:203-216)
        commands = []
        for i in range(bs):
            enc = (V(enc_pubs[i][0]), V(enc_pubs[i][1]))
            shared = scalar_mul_bits(cs, coord_bits, enc)
            dec = poseidon_decrypt_gadget(
                cs, [V(m) for m in msgs[i]], shared, LC.const(0),
                CIPHER_WORDS,
            )
            packed = dec[:4]
            w0_bits = num2bits_strict(cs, packed[0])

            def field(k):
                seg = w0_bits[50 * k : 50 * (k + 1)]
                return sum((b.scale(1 << j) for j, b in enumerate(seg)), LC())

            commands.append({
                "state_index": field(0), "vote_option": field(1),
                "weight": field(2), "nonce": field(3), "poll_id": field(4),
                "new_pub": (packed[1], packed[2]), "salt": packed[3],
                "sig_r8": (dec[4], dec[5]), "sig_s": dec[6],
                "packed": packed,
            })

        cs.mark("apply")
        # reverse-order application (:228-273)
        state_root_chain = V(current_state_root)
        ballot_root_chain = V(current_ballot_root)
        for i in range(bs - 1, -1, -1):
            cmd = commands[i]
            leaf = [V(x) for x in state_leaves[i]]
            ballot = [V(x) for x in ballots[i]]
            weight = V(vote_weights[i])

            # MessageValidatorNonQv (message-validator.circom:58-92)
            si_ok = less_than(cs, cmd["state_index"], V(num_signups), 252)
            vo_ok = less_than(cs, cmd["vote_option"],
                              LC.const(self.num_vote_options), 252)
            nonce_ok = is_equal(cs, ballot[0] + LC.const(1), cmd["nonce"])
            msg_hash = poseidon_gadget(cs, cmd["packed"])
            sig_ok = eddsa_poseidon_check(
                cs, (leaf[0], leaf[1]), cmd["sig_r8"], cmd["sig_s"], msg_hash)
            ts_ok = less_eq_than(cs, leaf[3], V(poll_end), 252)
            credits_ok = less_eq_than(cs, cmd["weight"], weight + leaf[2], 252)
            valid = is_equal(
                cs, si_ok + vo_ok + nonce_ok + sig_ok + ts_ok + credits_ok,
                LC.const(6))

            # transformer muxes (state-leaf-and-ballot-transformer.circom)
            new_pub_x = mux1(cs, valid, leaf[0], cmd["new_pub"][0])
            new_pub_y = mux1(cs, valid, leaf[1], cmd["new_pub"][1])
            new_nonce = mux1(cs, valid, ballot[0], cmd["nonce"])

            # path indices from (valid ? stateIndex : 0)
            si_mux = mux1(cs, si_ok, LC.const(0), cmd["state_index"])
            path_bits = cs.num2bits(si_mux, std)

            # state leaf membership at dynamic depth (:389-398)
            leaf_hash = poseidon_gadget(cs, leaf)
            state_elems = [V(e) for e in state_paths[i]]
            qip = binary_merkle_root_dynamic(
                cs, leaf_hash, V(actual_depth), path_bits, state_elems, std)
            cs.enforce_zero(qip - state_root_chain)

            # ballot membership at full depth (:404-415)
            ballot_hash = poseidon_gadget(cs, ballot)
            ballot_elems = [V(e) for e in ballot_paths[i]]
            bqip = merkle_inclusion_binary(cs, ballot_hash, path_bits,
                                           ballot_elems)
            cs.enforce_zero(bqip - ballot_root_chain)

            # vote weight membership + update (:418-449)
            vo_mux = mux1(cs, vo_ok, LC.const(0), cmd["vote_option"])
            vo_digits = quin_generate_path_indices(cs, vo_mux, vod)
            wpath = [[V(e) for e in lvl] for lvl in weight_paths[i]]
            wq = quin_inclusion(cs, weight, vo_digits, wpath)
            cs.enforce_zero(wq - ballot[1])

            new_weight = mux1(cs, valid, weight, cmd["weight"])
            new_balance = mux1(cs, valid, leaf[2],
                               leaf[2] + weight - cmd["weight"])
            new_vo_root_q = quin_inclusion(cs, new_weight, vo_digits, wpath)
            new_vo_root = mux1(cs, valid, ballot[1], new_vo_root_q)

            # new roots (:452-475)
            new_leaf_hash = poseidon_gadget(
                cs, [new_pub_x, new_pub_y, new_balance, leaf[3]])
            state_root_chain = binary_merkle_root_dynamic(
                cs, new_leaf_hash, V(actual_depth), path_bits, state_elems,
                std)
            new_ballot_hash = poseidon_gadget(cs, [new_nonce, new_vo_root])
            ballot_root_chain = merkle_inclusion_binary(
                cs, new_ballot_hash, path_bits, ballot_elems)

        cs.mark("new_sb")
        # new sb commitment (:275-276)
        cs.enforce_zero(
            poseidon_gadget(cs, [state_root_chain, ballot_root_chain,
                                 V(new_sb_salt)]) - V(new_sb)
        )
        self.cs = cs

    # -- witness assembly -----------------------------------------------------

    def assignment(self, values: dict) -> list[int]:
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
        return [values[k] % P for k in (
            "numSignUps", "pollEndTimestamp", "msgRoot",
            "actualStateTreeDepth", "batchEndIndex", "index",
            "coordinatorPublicKeyHash", "currentSbCommitment",
            "newSbCommitment")]
