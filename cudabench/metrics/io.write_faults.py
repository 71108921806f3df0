"""Mean minor page faults a window call in the program's ``io.write``
span."""

from cudabench import program_trace


def read(run):
    return program_trace.mean_faults(run, "io.write")
