"""Milliseconds of the MSM kernels a proof (recode, scatter, compaction,
accumulation, weighted sum), from the device trace: their summed durations
in the window over its proofs."""

GROUPS = ("msm_recode", "msm_scatter", "msm_compact", "msm_accum",
          "msm_weighted")


def read(run):
    if run.trace is None or not run.records:
        return None
    secs = run.trace.kernel_s(GROUPS)
    return secs / len(run.records) * 1e3 if secs else None
