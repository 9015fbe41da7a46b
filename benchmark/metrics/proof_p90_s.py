"""The 90th percentile (nearest rank), over every proof of the window, of
the seconds from the call to prove to the verified, serialized proof
(host clock)."""

from harness.window import percentile


def read(run):
    return percentile([r.latency for r in run.records], 0.9)
