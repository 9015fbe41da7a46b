"""The MSM kernels' share of their roofline, in percent: the least time
of every proof's five MSMs (harness/yardstick.py, from each proof's inputs
alone) over the time of the MSM kernels in the device trace, over the
window."""

from harness import spec
from harness.yardstick import proof_least_s


def read(run):
    if run.trace is None or run.proof_msms is None or not run.done:
        return None
    device_s = run.trace.kernel_s(spec.module("msm_device_ms").GROUPS)
    if not device_s:
        return None
    least = sum(proof_least_s(run.proof_msms(r.witness)) for r in run.done)
    return least / device_s * 100
