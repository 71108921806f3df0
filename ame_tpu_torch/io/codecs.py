"""ctypes binding for the native codec shim (``io/native/amecodec.cpp``):
MP3 encode through LAME and decode through mpg123, both ``dlopen``ed at run
time, and the in-house FLAC decoder (``io/flac.py``).

Port of ``ame_tpu/io/codecs.py``. The shim is the port's own copy of the
sources, compiled with ``g++`` into ``ame_tpu_torch/_build/`` by
``ops._build.build_host`` (content hash, temp file and rename; never
``make`` in the source directory). As in the reference
(``ame_tpu/io/native/Makefile``), one library holds the codecs and the
prefetch loader (``io/native/ameloader.cpp``, bound by ``io/loader.py``);
the library's hash covers both sources. Graceful degradation keeps the
reference's optional-dependency policy: if the shim cannot build or the
system libraries are absent, MP3 support reports unavailable (logged)
instead of failing the pipeline — MP3 export failures are warnings in the
reference too (engine:150).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("ame_tpu_torch.io")

_NATIVE = Path(__file__).resolve().parent / "native"
_SOURCES = (_NATIVE / "amecodec.cpp", _NATIVE / "ameloader.cpp")

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL | None:
    """The loaded shim, built on first use; None (logged once) when it
    cannot be built or loaded."""
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        from ame_tpu_torch.ops._build import build_host
        try:
            path = build_host("amecodec", _SOURCES, ("-ldl", "-lpthread"))
            lib = ctypes.CDLL(str(path["path"]))
        except (RuntimeError, OSError) as e:  # no toolchain: degrade
            log.warning("amecodec unavailable: %s", e)
            return None
        lib.ame_mp3_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ame_mp3_encode.restype = ctypes.c_int
        lib.ame_mp3_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.ame_mp3_decode.restype = ctypes.c_int
        lib.ame_flac_decode.argtypes = lib.ame_mp3_decode.argtypes
        lib.ame_flac_decode.restype = ctypes.c_int
        lib.ame_free.argtypes = [ctypes.c_void_p]
        lib.ame_have_lame.restype = ctypes.c_int
        lib.ame_have_mpg123.restype = ctypes.c_int
        _lib = lib
        return _lib


def have_mp3_encode() -> bool:
    lib = _load()
    return bool(lib and lib.ame_have_lame())


def have_mp3_decode() -> bool:
    lib = _load()
    return bool(lib and lib.ame_have_mpg123())


def decode_call(fn, path: str, what: str):
    """Run one of the shim's decoders (path, &out, &n, &ch, &rate) and copy
    its malloc'd interleaved float32 out: (audio [N, C] float32, rate)."""
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    ch = ctypes.c_int()
    rate = ctypes.c_int()
    rc = fn(path.encode(), ctypes.byref(out), ctypes.byref(n),
            ctypes.byref(ch), ctypes.byref(rate))
    if rc != 0:
        raise RuntimeError(f"{what} failed (code {rc}) for {path}")
    try:
        count = n.value * ch.value
        buf = np.ctypeslib.as_array(out, shape=(count,)).copy()
    finally:
        _lib.ame_free(out)
    return buf.reshape(n.value, ch.value), rate.value


def encode_mp3(path: str, audio: np.ndarray, sample_rate: int,
               vbr_quality: int = 0) -> None:
    """LAME VBR encode; vbr_quality 0 == the reference's `-q:a 0` (V0,
    engine:147)."""
    lib = _load()
    if not (lib and lib.ame_have_lame()):
        raise RuntimeError("MP3 encode unavailable (libmp3lame not found)")
    audio = np.ascontiguousarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    n, c = audio.shape
    rc = lib.ame_mp3_encode(
        path.encode(), audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, int(sample_rate), int(vbr_quality))
    if rc != 0:
        raise RuntimeError(f"MP3 encode failed (code {rc})")


def decode_mp3(path: str):
    """Returns (audio [N, C] float32, sample_rate)."""
    lib = _load()
    if not (lib and lib.ame_have_mpg123()):
        raise RuntimeError("MP3 decode unavailable (libmpg123 not found)")
    return decode_call(lib.ame_mp3_decode, path, "MP3 decode")
