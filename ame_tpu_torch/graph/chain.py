"""The mastering graph (PyTorch port).

Port of ``ame_tpu/graph/chain.py``: ``params_from_settings``, the compat
stages ``_stage_analog_compat``, ``_stage_eq_width_compat`` and
``_stage_multiband_compat``, ``_stage_pre_quality``, ``_stage_normalize``,
``_master_compat``, ``_master_quality`` and ``master_graph``. The stage order
is the reference's (audio_mastering_engine.py:185-223): analog character ->
EQ -> width -> multiband -> loudness normalize -> limiter, over one [N, 2]
float32 tensor on one device.

* ``compat`` reproduces the reference chain's quirks: blend EQ (Q1-Q3),
  int16 re-quantization at every stage boundary (Q5), the subtractive
  crossover (Q4) with exact pydub compression and saturating adds (Q7),
  ffmpeg's two-pass loudnorm with silent passthrough (Q9) and the
  ffmpeg-contract alimiter, always on (Q8).
  ``compat_chunked=True`` adds the reference's 30 s segment loop (Q6): the
  filters, the compressor's detectors and its gain state restart every
  ``COMPAT_CHUNK_SECONDS`` (read at call time); loudnorm and the limiter
  stay continuous, as in the reference.
* ``quality`` is the product chain: RBJ EQ, continuous f32 state, the
  Linkwitz-Riley multiband (3 bands, or G bands with ``mb_edges``), the
  lookahead limiter.

The port runs eagerly, so there is no fused one-program variant.
"""

from __future__ import annotations

import time

import torch

from ame_tpu_torch import config as C
from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph import multiband as mb
from ame_tpu_torch.ops import eq, quantize, saturate, stereo
from ame_tpu_torch.ops.limiter import alimiter_compat, lookahead_limiter
from ame_tpu_torch.ops.loudness import normalize_two_pass
from ame_tpu_torch.ops.loudnorm import loudnorm_two_pass


def params_from_settings(s: MasterSettings, device="cpu") -> dict:
    """The graph's parameters: scalars as host floats (they design the
    stages' filter coefficients on the host) and the per-band multiband
    vectors as float32 tensors on ``device``."""
    G = None if s.mb_edges is None else len(s.mb_edges) + 1
    threshs = ((s.low_thresh, s.mid_thresh, s.high_thresh) if G is None
               else s.mb_thresholds or (-20.0,) * G)
    ratios = ((s.low_ratio, s.mid_ratio, s.high_ratio) if G is None
              else s.mb_ratios or (3.0,) * G)
    return {
        "analog": float(s.analog_character),
        "bass": float(s.bass_boost),
        "mid_cut": float(s.mid_cut),
        "presence": float(s.presence_boost),
        "treble": float(s.treble_boost),
        "width": float(s.width),
        "lufs": float(s.lufs if s.lufs is not None else -14.0),
        "tp": float(s.target_tp),
        "lra": float(s.target_lra),
        "threshs": torch.tensor(threshs, dtype=torch.float32, device=device),
        "ratios": torch.tensor(ratios, dtype=torch.float32, device=device),
    }


def _stage_analog_compat(x, analog, sample_rate, chunk_len=None):
    y = saturate.analog_character_compat(x, sample_rate, analog, chunk_len)
    return quantize.int16_roundtrip(y)


def _stage_eq_width_compat(x, bass, mid_cut, presence, treble, sample_rate,
                           width_on, width=None, chunk_len=None):
    y = eq.apply_eq_compat(x, sample_rate, bass, mid_cut, presence, treble,
                           chunk_len)
    if width_on:
        y = stereo.stereo_width(y, width)
    return quantize.int16_roundtrip(y)


def _stage_multiband_compat(x, threshs, ratios, sample_rate, chunk_len=None):
    return mb.multiband_compat(x, sample_rate, threshs, ratios, chunk_len)


def _stage_multiband_quality(x, threshs, ratios, sample_rate, mb_edges=None):
    if mb_edges is None:
        return mb.multiband_quality(x, sample_rate, threshs, ratios)
    return mb.multiband_quality_n(x, sample_rate, mb_edges, threshs, ratios)


def _stage_normalize(x, target, tp, lra, n_valid, sample_rate, requantize):
    """compat (``requantize``): ffmpeg's two-pass loudnorm flow
    (engine:227-246), written back as int16 (pass 2 writes pcm_s16le).
    quality: the clean gain of ``normalize_two_pass``."""
    if requantize:
        y, info = loudnorm_two_pass(x, sample_rate, target, tp, lra,
                                    n_valid=n_valid)
        return quantize.int16_roundtrip(y), info
    return normalize_two_pass(x, sample_rate, target, n_valid=n_valid)


def _stage_pre_quality(x, analog, bass, mid_cut, presence, treble,
                       sample_rate, analog_on, width_on, width=None):
    if analog_on:
        x = saturate.analog_character_quality(x, sample_rate, analog)
    x = eq.apply_eq_quality(x, sample_rate, bass, mid_cut, presence, treble)
    if width_on:
        x = stereo.stereo_width_quality(x, width)
    return x


class _StageClock:
    """Per-stage seconds into an optional ``timer`` dict.

    On CUDA each stage is bracketed by ``torch.cuda.Event``s and the times
    are resolved once, in ``finish``, after the last stage — no sync between
    stages. On the CPU the ops run synchronously and the host clock is used.
    With no sink it is a pass-through."""

    def __init__(self, sink: dict | None, device: torch.device):
        self.sink = sink
        self.cuda = device.type == "cuda"
        self.events = []

    def __call__(self, name, thunk):
        if self.sink is None:
            return thunk()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = thunk()
            end.record()
            self.events.append((name, start, end))
            return out
        t0 = time.perf_counter()
        out = thunk()
        self._add(name, time.perf_counter() - t0)
        return out

    def _add(self, name, seconds):
        self.sink[name] = self.sink.get(name, 0.0) + seconds

    def finish(self):
        for name, start, end in self.events:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1000.0)
        self.events = []


def _master_compat(x, sample_rate, p, *, analog_on, width_on, multiband_on,
                   lufs_on, chunked=False, n_valid=None, timer=None):
    # engine:178: the reference's 30 s segments, read at call time
    chunk_len = int(C.COMPAT_CHUNK_SECONDS * sample_rate) if chunked else None
    info = {}
    clock = _StageClock(timer, x.device)
    if analog_on:  # engine:192
        x = clock("analog", lambda: _stage_analog_compat(
            x, p["analog"], sample_rate, chunk_len))
    x = clock("eq_width", lambda: _stage_eq_width_compat(  # engine:194-196
        x, p["bass"], p["mid_cut"], p["presence"], p["treble"], sample_rate,
        width_on, p["width"], chunk_len))
    if multiband_on:  # engine:197
        # thresholds and ratios design nothing on the device: one fetch
        threshs, ratios = p["threshs"].tolist(), p["ratios"].tolist()
        x = clock("multiband", lambda: _stage_multiband_compat(
            x, threshs, ratios, sample_rate, chunk_len))
    if lufs_on:  # engine:216-220
        x, loud_info = clock("loudnorm", lambda: _stage_normalize(
            x, p["lufs"], p["tp"], p["lra"], n_valid, sample_rate, True))
        info.update(loud_info)
    # engine:223: alimiter, always (quirk Q8), with ffmpeg-contract ramps and
    # the default auto-level 1/limit output scale
    x = clock("limiter", lambda: alimiter_compat(
        x, sample_rate, C.LIMITER_CEILING, C.LIMITER_ATTACK_MS,
        C.LIMITER_RELEASE_MS))
    clock.finish()
    return x, info


def _master_quality(x, sample_rate, p, *, analog_on, width_on, multiband_on,
                    lufs_on, n_valid=None, timer=None, mb_edges=None):
    info = {}
    clock = _StageClock(timer, x.device)
    x = clock("analog_eq_width", lambda: _stage_pre_quality(
        x, p["analog"], p["bass"], p["mid_cut"], p["presence"], p["treble"],
        sample_rate, analog_on, width_on, p["width"]))
    if multiband_on:
        x = clock("multiband", lambda: _stage_multiband_quality(
            x, p["threshs"], p["ratios"], sample_rate, mb_edges))
    if lufs_on:
        x, loud_info = clock("loudnorm", lambda: _stage_normalize(
            x, p["lufs"], p["tp"], p["lra"], n_valid, sample_rate, False))
        info.update(loud_info)
    x = clock("limiter", lambda: lookahead_limiter(
        x, sample_rate, C.LIMITER_CEILING, C.LIMITER_ATTACK_MS,
        C.LIMITER_RELEASE_MS))
    clock.finish()
    return x, info


def master_graph(x: torch.Tensor, sample_rate: float, settings,
                 n_valid: int | None = None, timer: dict | None = None) -> tuple:
    """Run the mastering graph.

    Args:
      x: [N, 2] float32 tensor in [-1, 1) (int16-grid values in compat mode,
        as ``api.master_array`` stages them); the graph runs on its device.
      sample_rate: track sample rate.
      settings: MasterSettings (or reference settings dict).
      n_valid: true track length when x carries trailing padding.
      timer: optional dict; per-stage seconds are accumulated into it.

    Returns:
      (y, info): mastered [N, 2] float32 and the loudness stats as 0-d
      tensors (when normalization ran).
    """
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    (mode, chunked, multiband_on, analog_on, width_on, lufs_on,
     mb_edges) = settings.structure_key()
    if mode == "compat" and mb_edges is not None:
        raise ValueError("mb_edges (G-band multiband) is quality-mode only; "
                         "compat mode is pinned to the reference's 3-band "
                         "stage")
    precision.apply()
    p = params_from_settings(settings, x.device)
    if mode == "compat":
        return _master_compat(
            x, float(sample_rate), p, analog_on=analog_on, width_on=width_on,
            multiband_on=multiband_on, lufs_on=lufs_on, chunked=chunked,
            n_valid=n_valid, timer=timer)
    return _master_quality(
        x, float(sample_rate), p, analog_on=analog_on, width_on=width_on,
        multiband_on=multiband_on, lufs_on=lufs_on, n_valid=n_valid,
        timer=timer, mb_edges=mb_edges)
