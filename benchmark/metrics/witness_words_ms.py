"""Milliseconds a proof spends converting the witness to standard-form words on
the card (`rowval.ints_to_words`, the host-to-device copy included): the
program's span `prove.h_dispatch.words`, summed over the window and divided
by its finished proofs (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "prove.h_dispatch.words")
