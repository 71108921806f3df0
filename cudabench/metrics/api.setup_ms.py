"""Host ms of set-up's ``api.master`` spans (the warm masters), less the
``ops.build`` spans inside them, so that a build does not split the
metric in two."""

from cudabench import program_trace


def read(run):
    return program_trace.setup_ms(run)
