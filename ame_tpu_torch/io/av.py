"""ctypes binding for the universal-format FFmpeg shim
(``io/native/ameav.cpp``).

Port of ``ame_tpu/io/av.py``. Extends the first-class decoders (WAV / AIFF
in ``io/wav.py``, FLAC in ``io/flac.py``, MP3 in ``amecodec.cpp``) to every
container and codec the system libavformat / libavcodec build supports —
the reference's "any input ffmpeg handles" surface
(audio_mastering_engine.py:190, SURVEY §2.3 N1) — without subprocesses.
The shim is compiled with ``g++`` into ``ame_tpu_torch/_build/``
(``ops._build.build_host``) against ``-lavformat -lavcodec -lswresample
-lavutil``; where the FFmpeg development files are absent the build fails,
is logged, and ``have_av()`` is False, so the format dispatch reports the
format unsupported (the reference's optional-dependency policy,
engine:20-26).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("ame_tpu_torch.io")

_SOURCE = Path(__file__).resolve().parent / "native" / "ameav.cpp"
_LIBS = ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")

# Containers/codecs routed here by io/audio_file.py. Anything else falls
# through to this shim too (after magic sniffing fails), so the list is
# advisory — used for dispatch priority and user-facing capability reports.
DECODE_EXTENSIONS = (
    ".ogg", ".oga", ".opus", ".m4a", ".mp4", ".aac", ".wma", ".asf",
    ".wv", ".ape", ".mka", ".webm", ".caf", ".au", ".amr", ".ac3",
)
ENCODE_EXTENSIONS = (".flac", ".ogg", ".oga", ".opus", ".m4a", ".aac")

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        from ame_tpu_torch.ops._build import build_host
        try:
            path = build_host("ameav", [_SOURCE], _LIBS)
            lib = ctypes.CDLL(str(path["path"]))
        except (RuntimeError, OSError) as e:  # FFmpeg dev files missing
            log.warning("ameav unavailable: %s", str(e).splitlines()[0])
            return None
        lib.ame_av_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.ame_av_decode.restype = ctypes.c_int
        lib.ame_av_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int]
        lib.ame_av_encode.restype = ctypes.c_int
        lib.ame_av_free.argtypes = [ctypes.c_void_p]
        lib.ame_av_have.restype = ctypes.c_int
        lib.ame_av_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def have_av() -> bool:
    lib = _load()
    return bool(lib and lib.ame_av_have())


def _last_error(lib) -> str:
    msg = lib.ame_av_error()
    return msg.decode(errors="replace") if msg else ""


def decode(path: str):
    """Decode any libavformat-supported file.

    Returns (audio [N, C<=2] float32, sample_rate). Sources with more than
    two channels are downmixed to stereo in the shim (swresample default
    matrix); the pipeline's force_stereo edge handles mono.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("universal decode unavailable "
                           "(FFmpeg libraries not found)")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong()
    ch = ctypes.c_int()
    rate = ctypes.c_int()
    rc = lib.ame_av_decode(path.encode(), ctypes.byref(out), ctypes.byref(n),
                           ctypes.byref(ch), ctypes.byref(rate))
    if rc != 0:
        raise RuntimeError(
            f"decode failed (code {rc}: {_last_error(lib)}): {path}")
    try:
        buf = np.ctypeslib.as_array(out, shape=(n.value * ch.value,)).copy()
    finally:
        lib.ame_av_free(out)
    return buf.reshape(n.value, ch.value), rate.value


def encode(path: str, audio: np.ndarray, sample_rate: int,
           codec: str | None = None, bitrate: int = 0) -> None:
    """Encode interleaved float32 audio; container picked from `path`'s
    extension, codec by extension unless `codec` overrides. `bitrate`=0
    uses a transparent-class default (192 kb/s) for lossy codecs."""
    lib = _load()
    if lib is None:
        raise RuntimeError("universal encode unavailable "
                           "(FFmpeg libraries not found)")
    audio = np.ascontiguousarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    n, c = audio.shape
    rc = lib.ame_av_encode(
        path.encode(), audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, int(sample_rate), codec.encode() if codec else None,
        int(bitrate))
    if rc != 0:
        raise RuntimeError(
            f"encode failed (code {rc}: {_last_error(lib)}): {path}")
