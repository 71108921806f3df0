"""Run REAL FFmpeg audio filters in-process — the golden-validation edge.

Port of ``ame_tpu/io/avfilter.py``. The reference's loudness / limit stage
is literally the ffmpeg CLI (audio_mastering_engine.py:223, 229-241:
``loudnorm=...print_format=json`` pass 1, ``loudnorm=...measured_*`` pass
2, ``alimiter=...`` on every master). The port re-implements those filters
on the device; this module is how the re-implementations are *proved*
against the genuine article rather than against a model of it: it drives
the FFmpeg 8 filter stack that ships inside the opencv-python wheel
(libavfilter 11 + its avutil / swresample) through the port's own copy of
the native shim, ``io/native/amefilter.cpp`` (pure ``dlopen``: no FFmpeg
headers or link-time libraries).

The shim is compiled with ``g++`` into ``ame_tpu_torch/_build/`` by
``ops._build.build_host`` (a lock per library, temp file and rename; never
``make`` in the source directory). Everything degrades: if no libavfilter
is found, the shim does not build, or its runtime ABI self-check fails,
:func:`available` is False and :func:`unavailable_reason` says why.

Not part of the mastering pipeline — validation / tooling only.
"""

from __future__ import annotations

import ctypes
import glob
import json
import logging
import os
import re
import sys
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("ame_tpu_torch.io")

_SOURCE = Path(__file__).resolve().parent / "native" / "amefilter.cpp"

_lib = None
_lib_tried = False
_reason: str | None = None
_lib_lock = threading.Lock()


def _find_avfilter() -> str | None:
    """Locate a libavfilter >= 10 shared object (``AME_TPU_AVFILTER``
    first, then the opencv-python wheel's bundled copy in site-packages)."""
    env = os.environ.get("AME_TPU_AVFILTER")
    if env:
        return env if os.path.exists(env) else None
    roots = [p for p in sys.path if p.endswith("site-packages")]
    try:
        import site
        roots = site.getsitepackages() + roots
    except Exception:  # noqa: BLE001 — a broken site module: sys.path only
        pass
    for root in dict.fromkeys(roots):
        hits = sorted(glob.glob(os.path.join(
            root, "opencv_python*.libs", "libavfilter*.so*")))
        if hits:
            return hits[-1]
    return None


def _unavailable(reason: str):
    global _reason
    _reason = reason
    logger.info("amefilter unavailable: %s", reason)
    return None


def _load():
    """The loaded, self-checked shim; None (with the reason kept) when the
    harness cannot run here."""
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so_path = _find_avfilter()
        if so_path is None:
            return _unavailable("no libavfilter found (set AME_TPU_AVFILTER "
                                "or install opencv-python)")
        from ame_tpu_torch.ops._build import build_host
        try:
            built = build_host("amefilter", [_SOURCE], ("-ldl",))
            lib = ctypes.CDLL(str(built["path"]))
        except (RuntimeError, OSError) as e:
            return _unavailable(f"shim build or load failed: {e}")
        lib.ame_flt_init.argtypes = [ctypes.c_char_p]
        lib.ame_flt_init.restype = ctypes.c_int
        lib.ame_flt_selfcheck.restype = ctypes.c_int
        lib.ame_flt_error.restype = ctypes.c_char_p
        lib.ame_flt_free.argtypes = [ctypes.c_void_p]
        lib.ame_flt_run.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_char_p)]
        lib.ame_flt_run.restype = ctypes.c_longlong
        if lib.ame_flt_init(so_path.encode()) != 0:
            return _unavailable(
                f"init of {so_path} failed: "
                f"{lib.ame_flt_error().decode(errors='replace')}")
        if lib.ame_flt_selfcheck() != 1:
            return _unavailable(
                f"ABI self-check against {so_path} failed: "
                f"{lib.ame_flt_error().decode(errors='replace')}")
        _lib = lib
        return _lib


def available() -> bool:
    """True iff the real-ffmpeg filter harness is usable (libs found AND
    the runtime ABI self-check passed)."""
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why :func:`available` is False; None when it is True."""
    return None if _load() is not None else _reason


def run_filter(x: np.ndarray, sample_rate: int, desc: str):
    """Push ``x`` [N] or [N, C<=2] float32 through the filter-graph
    description ``desc`` (e.g. ``"loudnorm=I=-14:TP=-1.5:LRA=11"``).

    Returns (y [M, C] float32, out_sample_rate, log_text). ``log_text`` is
    everything the filters printed at AV_LOG_INFO and below — the same
    stream the reference scrapes ffmpeg's loudnorm JSON from.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("amefilter unavailable")
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    out = ctypes.POINTER(ctypes.c_float)()
    out_ch = ctypes.c_int()
    out_sr = ctypes.c_int()
    log_p = ctypes.c_char_p()
    got = lib.ame_flt_run(
        desc.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ch, int(sample_rate), ctypes.byref(out), ctypes.byref(out_ch),
        ctypes.byref(out_sr), ctypes.byref(log_p))
    log = (ctypes.string_at(log_p).decode(errors="replace")
           if log_p else "")
    if log_p:
        lib.ame_flt_free(log_p)
    if got < 0:
        raise RuntimeError(
            f"filter run failed ({got}): "
            f"{lib.ame_flt_error().decode(errors='replace')}; desc={desc}")
    try:
        y = np.ctypeslib.as_array(
            out, shape=(int(got) * out_ch.value,)).copy()
    finally:
        lib.ame_flt_free(out)
    return (y.reshape(int(got), out_ch.value), out_sr.value, log)


def parse_loudnorm_json(log: str) -> dict:
    """Extract the loudnorm stats JSON block from a filter log — the exact
    scrape the reference performs on ffmpeg stderr
    (audio_mastering_engine.py:231-237). Numeric fields are floated;
    ffmpeg's ``-inf`` strings become ``-math.inf``."""
    m = re.search(r"\{[^{}]*\"input_i\"[^{}]*\}", log, re.S)
    if not m:
        raise ValueError(f"no loudnorm JSON in log: {log[-400:]!r}")
    raw = json.loads(m.group(0))
    out = {}
    for k, v in raw.items():
        if isinstance(v, str):
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
        else:
            out[k] = v
    return out


def loudnorm_pass1(x: np.ndarray, sample_rate: int, i: float = -14.0,
                   tp: float = -1.5, lra: float = 11.0) -> dict:
    """Real ffmpeg loudnorm pass 1: returns the measured-stats dict."""
    _, _, log = run_filter(
        x, sample_rate,
        f"loudnorm=I={i}:TP={tp}:LRA={lra}:print_format=json")
    return parse_loudnorm_json(log)


def loudnorm_pass2(x: np.ndarray, sample_rate: int, measured: dict,
                   i: float = -14.0, tp: float = -1.5, lra: float = 11.0,
                   linear: bool = True, resample_to: int | None = None):
    """Real ffmpeg loudnorm pass 2 with measured_* values — the reference's
    second invocation (engine:239-241). Returns (y, out_sr, stats)."""
    desc = (f"loudnorm=I={i}:TP={tp}:LRA={lra}"
            f":measured_I={measured['input_i']}"
            f":measured_TP={measured['input_tp']}"
            f":measured_LRA={measured['input_lra']}"
            f":measured_thresh={measured['input_thresh']}"
            f":offset={measured['target_offset']}"
            f":linear={'true' if linear else 'false'}"
            f":print_format=json")
    if resample_to:
        desc += f",aresample={int(resample_to)}"
    y, out_sr, log = run_filter(x, sample_rate, desc)
    return y, out_sr, parse_loudnorm_json(log)


def alimiter(x: np.ndarray, sample_rate: int, limit: float = 0.98,
             attack: float = 5.0, release: float = 50.0,
             level: bool | None = None):
    """Real ffmpeg alimiter with the reference's parameter set
    (engine:223). Returns (y, out_sr)."""
    desc = (f"alimiter=level_in=1:level_out=1:limit={limit}"
            f":attack={attack}:release={release}")
    if level is not None:
        desc += f":level={'true' if level else 'false'}"
    y, out_sr, _ = run_filter(x, sample_rate, desc)
    return y, out_sr
