"""Milliseconds a proof's host waits for the card to finish every queued MSM
(the degree gate's read-back, queued behind the five MSM dispatches): the
program's span `prove.msm_wait.card`, summed over the window and divided by
its finished proofs (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "prove.msm_wait.card")
