"""Codec edge of the port: WAV/AIFF decode and encode at the host boundary
(counterpart of ``ame_tpu/io/__init__.py``)."""

from ame_tpu_torch.io.audio_file import (force_stereo, read_audio,  # noqa: F401
                                         write_audio)
