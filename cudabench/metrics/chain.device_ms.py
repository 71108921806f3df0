"""Mean device ms a window call from the first chain stage's start event
to the last stage's end event (the program's ``chain.<stage>`` spans);
nothing on the CPU."""

from cudabench import program_trace


def read(run):
    return program_trace.device_ms(run)
