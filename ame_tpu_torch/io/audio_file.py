"""Format dispatch for the port: WAV and AIFF only.

Port of ``ame_tpu/io/audio_file.py`` (``force_stereo``, ``read_audio``,
``write_audio``), a jax-free copy. MP3, FLAC and the FFmpeg-probed formats
need the C++ shims in ``ame_tpu/io/native/`` and are not ported yet
(ROADMAP.md); ``read_audio`` and ``write_audio`` raise on them.
"""

from __future__ import annotations

import os

import numpy as np

from ame_tpu_torch.io import wav as _wav

_NOT_PORTED = ("{path}: only WAV and AIFF are supported by ame_tpu_torch "
               "yet (other containers need the codec shims; see ROADMAP.md)")


def force_stereo(audio: np.ndarray) -> np.ndarray:
    """[N, C] -> [N, 2]: mono duplicated, multichannel keeps the front pair
    (the reference's set_channels(2) conditioning, engine:190)."""
    if audio.shape[1] == 1:
        return np.repeat(audio, 2, axis=1)
    if audio.shape[1] > 2:
        return audio[:, :2]
    return audio


def read_audio(path: str, prefer_int16: bool = False):
    """Decode a WAV or AIFF file -> ([N, C] audio, rate).

    ``prefer_int16``: PCM16 WAV comes back as raw int16, also when the file
    is recognized by its RIFF magic rather than its extension; every other
    format returns float32."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave"):
        return _wav.read_wav(path, prefer_int16=prefer_int16)
    if ext in (".aif", ".aiff", ".aifc"):
        return _wav.read_aiff(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return _wav.read_wav(path, prefer_int16=prefer_int16)
    if magic == b"FORM":
        return _wav.read_aiff(path)
    raise ValueError(_NOT_PORTED.format(path=path))


def write_audio(path: str, audio: np.ndarray, sample_rate: int,
                bits: int = 16) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave"):
        return _wav.write_wav(path, audio, sample_rate, bits)
    if ext in (".aif", ".aiff"):
        return _wav.write_aiff(path, audio, sample_rate, bits)
    raise ValueError(_NOT_PORTED.format(path=path))
