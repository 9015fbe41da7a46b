"""Milliseconds a proof spends assembling A, B and C from the MSMs' sums on the
host (`curve/bn254_host.py`): the program's span `prove.assembly`, summed
over the window and divided by its finished proofs (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "prove.assembly")
