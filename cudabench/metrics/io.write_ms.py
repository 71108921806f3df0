"""Mean host ms a track of ``ame_tpu_torch.io.write_audio`` (the WAV
encode and its write into the FIFO), over the window's calls of a traced
run."""

from cudabench.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "write")
