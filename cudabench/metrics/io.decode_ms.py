"""Mean host ms a track of ``ame_tpu_torch.io.read_audio`` (the WAV decode
to int16), over the window's calls of a traced run."""

from cudabench.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "decode")
