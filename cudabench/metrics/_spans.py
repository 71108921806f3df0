"""Shared arithmetic of the host-span readers."""


def mean_ms(run, name):
    ms = [(t1 - t0) * 1e3 for n, _, t0, t1 in run.spans if n == name]
    return sum(ms) / len(ms) if ms else None
