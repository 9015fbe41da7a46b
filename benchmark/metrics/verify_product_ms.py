"""Milliseconds a proof's native verify spends on the public inputs' IC
combination and the four Miller loops: the program's span `verify.product`,
summed over the window and divided by its finished proofs
(`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "verify.product")
