"""Device ms a track: the union of the device's activity intervals in the
profiled part of the window over the calls profiled."""


def read(run):
    t = run.trace
    if t is None or not t.calls or t.busy_s <= 0:
        return None
    return t.busy_s * 1e3 / len(t.calls)
