"""Seconds from the start of the run to the opening of the window: the
kernels' build or load, the circuit, the proving key, the program's
prewarm, the poll and its witnesses, and the warm-up proofs (host clock)."""


def read(run):
    return run.setup_s
