"""Format dispatch: one entry point per direction, like the reference's
"AudioSegment.from_file / export" surface but without subprocesses.

Port of ``ame_tpu/io/audio_file.py`` (``force_stereo``, ``read_audio``,
``write_audio``), a jax-free copy. First-class: WAV and AIFF (numpy), MP3
(the native shim's LAME / mpg123), FLAC (the shim's in-house decoder).
Everything else routes through the in-process FFmpeg shim (``io/av.py``)
where it builds. One repair over the reference: a file recognized by its
RIFF magic rather than its extension keeps ``prefer_int16``.
"""

from __future__ import annotations

import os

import numpy as np

from ame_tpu_torch.io import av as _av
from ame_tpu_torch.io import codecs as _codecs
from ame_tpu_torch.io import flac as _flac
from ame_tpu_torch.io import wav as _wav
from ame_tpu_torch.utils.telemetry import stage_timer

_WAV = (".wav", ".wave")
_AIFF_OUT = (".aif", ".aiff")


def force_stereo(audio: np.ndarray) -> np.ndarray:
    """[N, C] -> [N, 2]: mono duplicated, multichannel keeps the front pair
    (the reference's set_channels(2) conditioning, engine:190)."""
    if audio.shape[1] == 1:
        return np.repeat(audio, 2, axis=1)
    if audio.shape[1] > 2:
        return audio[:, :2]
    return audio


def read_audio(path: str, prefer_int16: bool = False, *, into=None):
    """Decode any supported file -> ([N, C] audio, rate).

    ``prefer_int16``: PCM16 WAV comes back as raw int16, also when the file
    is recognized by its RIFF magic rather than its extension; every other
    format returns float32. ``into``: where such a PCM16 read puts its
    samples (``io/wav.read_wav``)."""
    with stage_timer("io.decode"):
        return _read_audio(path, prefer_int16, into)


def _read_audio(path, prefer_int16, into):
    ext = os.path.splitext(path)[1].lower()
    if ext in _WAV:
        return _wav.read_wav(path, prefer_int16=prefer_int16, into=into)
    if ext in (".aif", ".aiff", ".aifc"):
        return _wav.read_aiff(path)
    if ext == ".mp3":
        return _codecs.decode_mp3(path)
    if ext == ".flac":
        return _flac.read_flac(path)
    if ext in _av.DECODE_EXTENSIONS and _av.have_av():
        return _av.decode(path)
    # fall back to sniffing WAV / AIFF / FLAC magic
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return _wav.read_wav(path, prefer_int16=prefer_int16, into=into)
    if magic == b"FORM":
        return _wav.read_aiff(path)
    if magic[:3] == b"fLa":
        return _flac.read_flac(path)
    if _av.have_av():  # unknown extension / magic: let libavformat probe it
        return _av.decode(path)
    raise ValueError(f"unsupported audio format: {path}")


def write_audio(path: str, audio: np.ndarray, sample_rate: int,
                bits: int = 16) -> None:
    with stage_timer("io.write"):
        _write_audio(path, audio, sample_rate, bits)


def writes_int16(path: str, bits: int) -> bool:
    """Whether ``write_audio`` writes int16 samples as they are there."""
    ext = os.path.splitext(path)[1].lower()
    return bits == 16 and ext in _WAV + _AIFF_OUT


def _write_audio(path, audio, sample_rate, bits):
    ext = os.path.splitext(path)[1].lower()
    if ext in _WAV:
        return _wav.write_wav(path, audio, sample_rate, bits)
    if ext == ".mp3":
        return _codecs.encode_mp3(path, audio, sample_rate, vbr_quality=0)
    if ext in _AIFF_OUT:
        return _wav.write_aiff(path, audio, sample_rate, bits)
    if ext in _av.ENCODE_EXTENSIONS and _av.have_av():
        return _av.encode(path, audio, sample_rate)
    raise ValueError(f"unsupported output format: {path}")
