"""Mean host ms a window call spends in the program's ``api.fetch`` span:
``float_to_int16``, the int16 cast and the pageable copy back, with the
wait for the chain's queued device work."""

from cudabench import program_trace


def read(run):
    return program_trace.mean_ms(run, "api.fetch")
