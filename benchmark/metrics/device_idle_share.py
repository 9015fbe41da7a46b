"""The device's idle share of the window, in percent: 1 less the union of
its kernels, copies and sets over the window's length (device trace)."""


def read(run):
    if run.trace is None or not run.trace.events:
        return None
    return (1 - run.trace.busy_s / run.trace.window_s) * 100
