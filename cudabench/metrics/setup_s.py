"""Set-up seconds: from the start of the process to the first timed call
(imports, the card's context, the kernels' build on a checkout's first run,
the input pool, one warm master a pool track)."""


def read(run):
    return run.setup_s
