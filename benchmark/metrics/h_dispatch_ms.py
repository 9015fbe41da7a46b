"""Milliseconds of the prover's `h_dispatch` stage a proof, as the program
records it in `groth16.LAST_PROVE_TRACE`: the witness's conversion to words
on the card and the H stage's enqueue (host clock, no sync), the mean over
the window's proofs."""


def read(run):
    spans = [r.stages["h_dispatch"] for r in run.done
             if "h_dispatch" in r.stages]
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
