"""Seconds of set-up spent in the key cache (`groth16/pkcache.py`
`setup_cached`, hit or miss, the circuit's fingerprint included): the
program's span `setup.key`, summed over its spans that end before the window
(`harness/spans.py`)."""

from harness import spans


def read(run):
    return spans.setup_s(run, "setup.key")
