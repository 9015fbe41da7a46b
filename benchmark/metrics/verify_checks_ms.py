"""Milliseconds a proof's native verify spends reading the key's and the
proof's points with their on-curve and subgroup checks, and the public
inputs' range: the program's span `verify.checks`, summed over the window
and divided by its finished proofs (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "verify.checks")
