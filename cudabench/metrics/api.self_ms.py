"""Mean host ms a window call spends in the program's ``api.master`` span
outside its child spans: the staging, the memory logs, the release of the
call's buffers."""

from cudabench import program_trace


def read(run):
    return program_trace.self_ms(run, "api.master")
