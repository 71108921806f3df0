"""Mean minor page faults a window call in the program's ``api.master``
span, its children included."""

from cudabench import program_trace


def read(run):
    return program_trace.mean_faults(run, "api.master")
