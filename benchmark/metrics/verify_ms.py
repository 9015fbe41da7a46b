"""Milliseconds a proof spends in the program's `verify` (the native
pairing, with the key and proof serialized for it): the benchmark's span
around the call (host clock), the mean over the window's proofs."""


def read(run):
    done = run.done
    if not done:
        return None
    return sum(r.verified - r.proved for r in done) / len(done) * 1e3
