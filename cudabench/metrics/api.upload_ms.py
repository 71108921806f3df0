"""Mean host ms a window call spends in the program's ``api.upload`` span:
the int16 staging, the pageable copy to the card and the conversion."""

from cudabench import program_trace


def read(run):
    return program_trace.mean_ms(run, "api.upload")
