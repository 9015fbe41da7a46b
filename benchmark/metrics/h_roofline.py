"""The H stage's share of its roofline, in percent: the least time of the
window's H stages (harness/h_yardstick.py, from the domain and row terms
the program counts on each `prove.h_dispatch` span) over the time of the H
kernels in the device trace (`h_device_ms`'s groups), over the window.
None where the spans carry no counters or the trace holds no H kernel."""

from harness import spec
from harness.h_yardstick import window_least_s


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.kernel_s(spec.module("h_device_ms").GROUPS)
    least = window_least_s(run.start, run.end)
    if not device_s or least is None:
        return None
    return least / device_s * 100
