"""Seconds of set-up spent in the program's prewarm (`ProverKeys.prewarm`: the
kernels' build or load, the hint program, a throwaway proof): the program's
span `setup.prewarm`, summed over its spans that end before the window
(`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.setup_s(run, "setup.prewarm")
