"""Proofs proved and self-verified in the window, over the window's
seconds (host clock)."""

from harness.window import rate


def read(run):
    return rate(run.records, run.window_s)
