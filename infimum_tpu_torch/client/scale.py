# Copied from infimum_tpu/client/scale.py; proves on `device`, and its checks
# raise rather than assert.
"""Production-scale poll harness: fill a poll to the reference's runtime
bounds and measure / project the full proving cost.

BASELINE.md's north star is the proof latency for a poll with ~2^14
interactions. The reference's own bounds cap a poll at 5^6 = 15,625
interactions (interaction trees are quinary, `max_interactions =
5^interaction_depth`, and depth 7 would exceed MaxPollInteractions =
65,536), so "2^14 = 16,384" is unreachable; this harness fills the largest
legal poll (15,624 messages, one below the exactly-full merge quirk pinned
in tests/test_pallet.py) and projects 2^14 from the measured per-batch
rates.

Everything except batch proving is run IN FULL and timed: key generation,
sign-ups, message publication (EdDSA sign + Poseidon encrypt + on-chain
tree inserts), state merges, event-stream replay, and witness-INPUT
generation for every process batch (the commitment chain forces a full
walk: batches are built last->first). Every batch's commitment then walks
through the pallet poll's `prepare_public_inputs`, and only
`sample_process` / `sample_tally` batches also run the witness assignment,
the Groth16 prove on `device` and the pairing verify against the
pallet-derived public inputs; the projection extrapolates the median, and
the sample sizes are reported alongside.
"""

from __future__ import annotations

import random
import statistics
import sys
import time

from .user import Coordinator, Participant
from .prover import PollProver, ProverKeys


def run_scale_poll(n_participants: int = 1022, n_messages: int = 15624,
                   sample_process: int = 8, sample_tally: int = 4,
                   registration_depth: int = 10, interaction_depth: int = 6,
                   vote_option_tree_depth: int = 2, prove: bool = True,
                   verbose: bool = False, seed: int = 20260820,
                   device="cuda") -> dict:
    from ..pallet import InfimumPallet
    from ..groth16.groth16 import prove as g16_prove, verify as g16_verify

    t: dict = {"n_participants": n_participants, "n_messages": n_messages}

    def clock(name):
        class _S:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                t[name] = round(time.perf_counter() - self.t0, 3)
                if verbose:
                    print(f"[{name}] {t[name]}s", file=sys.stderr, flush=True)
        return _S()

    max_regs = 2 ** registration_depth
    max_msgs = 5 ** interaction_depth
    if n_participants > max_regs - 2:
        raise ValueError("stay below the blank-leaf bound")
    if n_messages > max_msgs - 1:
        raise ValueError("stay below the full-tree merge quirk")

    with clock("build_circuits"):
        keys = (ProverKeys.generate(
                    registration_depth, interaction_depth, 1, 1,
                    vote_option_tree_depth, rng=random.Random(seed),
                    device=device)
                if prove else
                ProverKeys.dims_only(registration_depth, interaction_depth,
                                     1, 1, vote_option_tree_depth))
    n_options = 5 ** vote_option_tree_depth

    if prove:
        with clock("prewarm"):
            t["kernel_load_log"] = keys.prewarm(
                verbose=verbose, device=device)["kernel_load_log"]

    with clock("keygen"):
        coordinator = Coordinator("coord", sk=0xC00D, keys=keys)
        participants = [Participant(f"p{i}", sk=0x1000 + i)
                        for i in range(n_participants)]

    pallet = InfimumPallet()
    if prove:
        coordinator.register(pallet)
    else:
        # dims_only keys carry no real vkeys; register deserializable
        # placeholders from a 1-constraint setup on `device` (registration
        # only checks the byte encoding)
        from ..groth16.r1cs import ConstraintSystem, LC
        from ..groth16.groth16 import setup
        from ..io.arkworks import serialize_vkey

        cs = ConstraintSystem()
        x = cs.alloc_public()
        cs.enforce(LC.var(x), LC.var(x), LC.var(x))
        vk = serialize_vkey(setup(cs, random.Random(1), device).vk)
        pallet.register_as_coordinator(
            "coord", coordinator.public_key,
            {"process": vk, "tally": vk})
    coordinator.create_poll(pallet, 12, 12)
    pallet.run_to_block(2)

    with clock("signup"):          # hot loop: Poseidon4 leaf + IMT insert
        for p in participants:
            p.register(pallet, 0)
    pallet.run_to_block(14)
    with clock("merge_registrations"):
        coordinator.merge_poll_state(pallet)

    with clock("publish"):         # hot loop: sign + encrypt + IMT insert
        for i in range(n_messages):
            p = participants[i % n_participants]
            p.vote(pallet, 0, coordinator.public_key,
                   state_index=1 + (i % n_participants),
                   vote_option=(i % n_options), weight=1, nonce=1,
                   salt=10_000 + i)
    pallet.run_to_block(26)
    with clock("merge_interactions"):
        coordinator.merge_poll_state(pallet)

    poll = pallet.polls[0]
    prover = PollProver(keys, coordinator.keypair, poll.config,
                        poll_end_timestamp=poll.voting_period_end(),
                        rng=random.Random(7), device=device)
    with clock("ingest_events"):
        prover.ingest_events(pallet.events, 0)

    with clock("witness_inputs"):  # full walk of ALL batches, last -> first
        process_batches, tally_batches, tb = prover.get_poll_results()
    t["process_batches"] = len(process_batches)
    t["tally_batches"] = len(tally_batches)
    if (len(process_batches), len(tally_batches)) != (
            poll.commitment.expected_process, poll.commitment.expected_tally):
        raise AssertionError(
            f"{len(process_batches)} + {len(tally_batches)} batches, the "
            f"poll expects {poll.commitment.expected_process} + "
            f"{poll.commitment.expected_tally}")

    if not prove:
        return t

    # Every batch's commitment chains through the pallet's own
    # prepare_public_inputs cursor walk (validating all 3k+ metas against
    # chain semantics); only `sample_*` batches per circuit additionally run
    # the full witness + Groth16 prove + verify. The tally cursor only
    # unlocks after every process commitment has advanced, so the walk is
    # over the full chain, not just the samples.
    per_batch = {"process": [], "tally": []}
    rng = random.Random(9)
    with clock("chain_walk_and_sampled_proofs"):
        for kind, circuit, pk, batches, k in (
                ("process", keys.process_circuit, keys.process_pk,
                 process_batches, sample_process),
                ("tally", keys.tally_circuit, keys.tally_pk,
                 tally_batches, sample_tally)):
            for i, (values, meta) in enumerate(batches):
                pkind, inputs, new_c = poll.prepare_public_inputs(
                    coordinator.public_key, meta["new_commitment"])
                if pkind != kind or inputs != circuit.public_inputs(values):
                    raise AssertionError(f"{kind} batch {i}: the pallet's "
                                         f"public inputs differ")
                poll.commit(new_c)
                if i >= k:
                    continue
                t0 = time.perf_counter()
                witness = circuit.assignment(values)
                tw = time.perf_counter() - t0
                proof = g16_prove(pk, circuit.cs, witness, rng=rng,
                                  device=device)
                tp = time.perf_counter() - t0 - tw
                if not g16_verify(pk.vk, proof, inputs):
                    raise AssertionError(f"{kind} {i}: proof rejected")
                per_batch[kind].append(round(tw + tp, 3))
                t[f"witness_{kind}_{i}"] = round(tw, 3)
                t[f"prove_{kind}_{i}"] = round(tp, 3)
                if verbose:
                    print(f"[{kind}_{i}] witness {tw:.2f}s prove {tp:.2f}s",
                          file=sys.stderr, flush=True)

    # projection: median sampled batch x batch count, plus the fully
    # measured non-proving phases (the median leaves out sample 0's
    # one-time costs; sample sizes are reported). A tiny poll (or
    # sample_*=0) can leave a sample list empty: keep the measured phase
    # timings instead of failing on an empty median.
    med_p = (statistics.median(per_batch["process"])
             if per_batch["process"] else 0.0)
    med_t = (statistics.median(per_batch["tally"])
             if per_batch["tally"] else 0.0)
    if not (per_batch["process"] and per_batch["tally"]):
        t["sampled_process"] = len(per_batch["process"])
        t["sampled_tally"] = len(per_batch["tally"])
        return t
    overhead = sum(t[k] for k in ("signup", "merge_registrations", "publish",
                                  "merge_interactions", "ingest_events",
                                  "witness_inputs"))
    t["sampled_process"] = len(per_batch["process"])
    t["sampled_tally"] = len(per_batch["tally"])
    t["median_process_batch_s"] = round(med_p, 3)
    t["median_tally_batch_s"] = round(med_t, 3)
    t["projected_prove_s"] = round(
        med_p * len(process_batches) + med_t * len(tally_batches), 1)
    t["projected_total_s"] = round(t["projected_prove_s"] + overhead, 1)
    # 2^14 extrapolation (unreachable under the reference bounds; see the
    # module docstring): scale the per-message phases to 16,384 messages
    scale = 16384 / n_messages
    t["poll_2^14_projected_s"] = round(
        med_p * (-(-16384 // keys.process_circuit.batch_size))
        + med_t * len(tally_batches)
        + overhead * scale, 1)
    return t
