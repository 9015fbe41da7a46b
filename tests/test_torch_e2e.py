"""The port's reference e2e (infimum_tpu_torch.client.e2e) sums
`proof_latency_s` over the keys the reference sums
(`infimum_tpu/client/e2e.py`): the witness inputs, each batch's witness
and prove, and not its self-verify, which both time apart. Synthetic
timings; exact sums."""

import pytest

from infimum_tpu_torch.client.e2e import proof_latency

COUNTED = {"witness_inputs": 0.25, "witness_process_0": 0.5,
           "prove_process_0": 1.0, "witness_process_1": 0.125,
           "prove_process_1": 2.0, "witness_tally_0": 0.75,
           "prove_tally_0": 4.0}
LEFT_OUT = {"selfverify_process_0": 8.0, "selfverify_process_1": 16.0,
            "selfverify_tally_0": 32.0, "build_circuits": 64.0,
            "setup_process": 128.0, "setup_tally": 256.0,
            "lifecycle": 512.0, "commit_outcome": 1024.0}


def test_proof_latency_sums_reference_keys():
    timings = {**COUNTED, **LEFT_OUT, "process_constraints": 123456,
               "num_proofs": 3, "trace_process": {"msm": 9.0}}
    assert proof_latency(timings) == sum(COUNTED.values())


@pytest.mark.parametrize("key", sorted(LEFT_OUT))
def test_proof_latency_leaves_out(key):
    assert proof_latency({**COUNTED, key: LEFT_OUT[key]}) == \
        proof_latency(COUNTED)
