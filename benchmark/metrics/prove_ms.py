"""Milliseconds a proof spends in the program's `prove`, which returns
after its read-backs: the benchmark's span around the call (host clock),
the mean over the window's proofs."""


def read(run):
    done = run.done
    if not done:
        return None
    return sum(r.proved - r.start for r in done) / len(done) * 1e3
