"""Milliseconds a proof spends reading back the five MSMs' window sums and
combining each on the host (`msm/msm.py` `combine_window_points`, Horner),
with no card wait in it: the program's span `prove.msm_wait.combine`, summed
over the window and divided by its finished proofs (`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.per_proof_ms(run, "prove.msm_wait.combine")
