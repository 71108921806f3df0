"""Mean minor page faults a window call in the program's ``io.decode``
span."""

from cudabench import program_trace


def read(run):
    return program_trace.mean_faults(run, "io.decode")
