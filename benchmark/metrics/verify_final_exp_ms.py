"""Milliseconds a proof's native verify spends in the final exponentiation: the
program's span `verify.final_exp`, summed over the window and divided by its
finished proofs (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "verify.final_exp")
