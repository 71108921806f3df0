"""Audio seconds of every track mastered in the window over the window's
wall seconds (first timed call to the return of the last call that started
before ``--seconds``)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(c.seconds for c in run.calls if c.ok) / run.window_s
