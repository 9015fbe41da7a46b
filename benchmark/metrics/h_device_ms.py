"""Milliseconds of the H stage's kernels a proof (row evaluation, NTT tile
and pass, pointwise), from the device trace: their summed durations in the
window over its proofs."""

GROUPS = ("fr_rows", "fr_ntt_tile", "fr_ntt_pass", "fr_pointwise")


def read(run):
    if run.trace is None or not run.records:
        return None
    secs = run.trace.kernel_s(GROUPS)
    return secs / len(run.records) * 1e3 if secs else None
