"""Seconds of set-up spent building the cell's constraint system in Python
(`ProcessCircuit` / `TallyCircuit` `_build`): the program's span
`setup.circuit`, summed over its spans that end before the window
(`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.setup_s(run, "setup.circuit")
