"""pydub-semantics compression, the exact path (PyTorch port of
``ame_tpu/ops/compressor.py``: ``_detector_from_wsum``, ``pydub_detector``,
``_apply_attenuation_int``, ``pydub_compress_exact`` and
``pydub_compress_exact_multi``).

pydub ``compress_dynamic_range`` semantics (reference call site
audio_mastering_engine.py:306-308):
  * detector RMS is the integer audioop rms over the previous ``attack_ms``
    of frames, both channels, window exclusive of the current frame; rms 0
    while the window does not fit;
  * thresh_rms = 32768 · 10^(threshold_db/20);
  * max_att = (1 − 1/ratio) · max(0, 20·log10(rms/thresh_rms));
  * the attenuation recurrence of ``ops/pydub_gain`` (m == 0 freezes);
  * output = trunc(int_sample · 10^(−att/20)) saturated to int16, applied
    only where att != 0.

The clamp-approximation ``pydub_compress_fast`` and the chunked entry point
are not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.pydub_gain import pydub_gain_multi


def _f32(v: float) -> float:
    return float(np.float32(v))


def _div(t: torch.Tensor, v: float) -> torch.Tensor:
    """t / v rounded as a true f32 division (a python-scalar divisor may
    be turned into a multiply by its reciprocal on the card)."""
    return t / t.new_tensor(v)


def _detector_from_wsum(wsum: torch.Tensor, count: float,
                        idx_ge_look: torch.Tensor, threshold_db: float,
                        ratio: float):
    """The detector math downstream of the window sum. Returns
    (rms, max_att_db, thresh_rms)."""
    rms = torch.floor(torch.sqrt(_div(torch.clamp(wsum, min=0.0), count)))
    rms = torch.where(idx_ge_look, rms, torch.zeros_like(rms))
    thr = np.float32(threshold_db)
    thresh_rms = _f32(np.float32(32768.0)
                      * np.float32(10.0) ** (thr / np.float32(20.0)))
    db_over = torch.where(
        rms > 0,
        torch.clamp(20.0 * torch.log10(_div(torch.clamp(rms, min=1e-9),
                                            thresh_rms)), min=0.0),
        torch.zeros_like(rms))
    max_att = _f32(np.float32(1.0) - np.float32(1.0) / np.float32(ratio)) \
        * db_over
    return rms, max_att, thresh_rms


def pydub_detector(x_int: torch.Tensor, sample_rate: float,
                   threshold_db: float, ratio: float,
                   attack_ms: float = 5.0):
    """Per-frame integer RMS + max-attenuation, pydub conventions.
    x_int: [N, C] int16-valued float32. Returns (rms, max_att_db,
    thresh_rms) with rms and max_att [N]."""
    n, c = x_int.shape
    look = int(attack_ms * sample_rate / 1000.0)
    sq = torch.sum(x_int * x_int, dim=1)
    wsum = (W.windowed_sum_exclusive(sq, look) if look > 0
            else torch.zeros_like(sq))
    count = float(max(look, 1) * c)
    return _detector_from_wsum(wsum, count,
                               torch.arange(n, device=x_int.device) >= look,
                               threshold_db, ratio)


def _apply_attenuation_int(x_int: torch.Tensor,
                           att_db: torch.Tensor) -> torch.Tensor:
    """audioop.mul semantics: scale int16 samples, truncate toward zero,
    saturate; att == 0 exactly passes the samples through."""
    factor = 10.0 ** _div(-att_db, 20.0)
    scaled = torch.clamp(torch.trunc(x_int * factor[:, None]),
                         -32768.0, 32767.0)
    return torch.where((att_db == 0.0)[:, None], x_int, scaled)


def pydub_compress_exact(x_int: torch.Tensor, sample_rate: float,
                         threshold_db: float, ratio: float,
                         attack_ms: float = 5.0,
                         release_ms: float = 50.0) -> torch.Tensor:
    """Exact pydub compression of one [N, C] int16-valued band."""
    return pydub_compress_exact_multi([x_int], sample_rate, [threshold_db],
                                      [ratio], attack_ms, release_ms)[0]


def pydub_compress_exact_multi(bands, sample_rate: float, threshs, ratios,
                               attack_ms: float = 5.0,
                               release_ms: float = 50.0):
    """Compress G bands exactly in one gain-engine pass (the G chains run
    together). bands: list of [N, C]; returns a list."""
    ms = [pydub_detector(band, sample_rate, float(threshs[i]),
                         float(ratios[i]), attack_ms)[1]
          for i, band in enumerate(bands)]
    atts = pydub_gain_multi(ms, attack_ms * sample_rate / 1000.0,
                            release_ms * sample_rate / 1000.0)
    return [_apply_attenuation_int(bands[g], atts[g])
            for g in range(len(bands))]
