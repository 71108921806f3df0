"""FLAC decode through the native shim (``ame_flac_decode`` in
``io/native/amecodec.cpp``, the in-house bitstream decoder).

Port of ``ame_tpu/io/flac.py``: the reference's FLAC input capability
(mastering_gui.py:170 file filter; decoding went through ffmpeg, SURVEY.md
N1)."""

from __future__ import annotations

from ame_tpu_torch.io import codecs as _codecs


def read_flac(path: str):
    """Returns (audio [N, C] float32, sample_rate)."""
    lib = _codecs._load()
    if lib is None:
        raise RuntimeError("FLAC decode unavailable (native shim not built)")
    return _codecs.decode_call(lib.ame_flac_decode, path, "FLAC decode")
