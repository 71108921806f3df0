"""Async native data loader — prefetch-decode for fleet mastering.

Port of ``ame_tpu/io/loader.py``. Binds ``io/native/ameloader.cpp`` (the
port's own copy: a C++ thread pool decoding WAV natively and MP3 / FLAC
through the amecodec decoders of the same library, ``io/codecs.py``) over
ctypes. The blocking ``next`` call releases the GIL, so the decode of
upcoming tracks overlaps the device's mastering of the current one — the
framework's native data-loader tier (the reference shells out to ffmpeg
per file, audio_mastering_engine.py:229; SURVEY.md N1).

Degrade contract: if the shim is unavailable, or a file's format is not
native-decodable (e.g. AIFF), the loader falls back to the port's Python
decoders (``ame_tpu_torch.io.read_audio``) — same results, just not
prefetched; each such decode is logged at debug level. ``decodes`` counts
the route every yielded file took, by extension.

    with PrefetchLoader(paths, workers=4) as loader:
        for path, audio, sr in loader:   # audio [N, C] float32, in order
            ...
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

log = logging.getLogger("ame_tpu_torch.io")

#: {"native" | "python": {extension: files}} — the route of every file a
#: PrefetchLoader yielded in this process (a failed decode counts on the
#: Python route, the last one it tried). Reset it by assigning new dicts.
decodes: dict[str, dict[str, int]] = {"native": {}, "python": {}}

_bound = None
_bind_lock = threading.Lock()


def _lib():
    """The amecodec library with the loader's symbols bound; None when the
    shim cannot be built or loaded (``codecs._load`` logs why)."""
    global _bound
    from ame_tpu_torch.io import codecs
    lib = codecs._load()
    if lib is None:
        return None
    with _bind_lock:
        if _bound is None:
            lib.ame_loader_open.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
            lib.ame_loader_open.restype = ctypes.c_void_p
            lib.ame_loader_next.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.ame_loader_next.restype = ctypes.c_int
            lib.ame_loader_close.argtypes = [ctypes.c_void_p]
            _bound = lib
    return _bound


def _count(route: str, path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    decodes[route][ext] = decodes[route].get(ext, 0) + 1


class PrefetchLoader:
    """Iterate (path, audio [N, C] float32, sample_rate) in submission
    order, decoding ahead on native worker threads."""

    def __init__(self, paths: list[str], workers: int = 4):
        self.paths = list(paths)
        self._handle = None
        self._lib = _lib()
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.ame_loader_open(
                arr, len(self.paths), int(workers))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._handle is not None:
            self._lib.ame_loader_close(self._handle)
            self._handle = None

    def _fallback(self, path: str):
        """Python decode; decode failures surface as (None, exc) so a
        fleet iteration can mark ONE file failed and continue."""
        from ame_tpu_torch.io import read_audio
        _count("python", path)
        try:
            return read_audio(path)
        except Exception as e:  # noqa: BLE001 — handed to the caller
            return None, e

    def __iter__(self):
        """Yields (path, audio [N, C] float32, sample_rate); on a decode
        failure yields (path, None, exception) instead."""
        for i, path in enumerate(self.paths):
            if self._handle is None:
                log.debug("native loader unavailable: %s -> python", path)
                audio, sr = self._fallback(path)
                yield path, audio, sr
                continue
            out = ctypes.POINTER(ctypes.c_float)()
            n = ctypes.c_long()
            ch = ctypes.c_int()
            rate = ctypes.c_int()
            err = ctypes.create_string_buffer(200)
            rc = self._lib.ame_loader_next(
                self._handle, i, ctypes.byref(out), ctypes.byref(n),
                ctypes.byref(ch), ctypes.byref(rate), err, len(err))
            if rc != 0:
                log.debug("native loader: %s -> rc %d (%s); python fallback",
                          path, rc, err.value.decode(errors="replace"))
                audio, sr = self._fallback(path)
                yield path, audio, sr
                continue
            try:
                nvals = n.value * ch.value
                audio = np.ctypeslib.as_array(out, (nvals,)).reshape(
                    n.value, ch.value).copy()
            finally:
                self._lib.ame_free(out)
            _count("native", path)
            yield path, audio, int(rate.value)
