"""Compression (PyTorch port of ``ame_tpu/ops/compressor.py``): the exact
pydub path (``_detector_from_wsum``, ``pydub_detector``,
``_apply_attenuation_int``, ``pydub_compress_exact``,
``pydub_compress_exact_multi`` and ``pydub_compress_exact_multi_chunked``)
and the quality compressor (``compress_quality_multi``,
``compress_quality``: windowed-RMS level in dB, threshold/ratio gain
computer, (x, max) release scan, one-pole attack smoother).

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

The clamp-approximation ``pydub_compress_fast`` (``_clip_combine``,
``_pydub_gain_fast``) takes the gain branch from the detector instead of
the state, which makes the walk associative; it is plain torch, as it is
plain XLA in ``ame_tpu``, and ``graph/multiband.multiband_compat(
exact=False)`` reaches it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.pydub_gain import pydub_gain_chunked, pydub_gain_multi
from ame_tpu_torch.ops.scan_iir import sosfilt


def _f32(v: float) -> float:
    return float(np.float32(v))


def _div(t: torch.Tensor, v: float) -> torch.Tensor:
    """t / v rounded as a true f32 division (a python-scalar divisor may
    be turned into a multiply by its reciprocal on the card). The divisor
    is filled on t's device, not copied from the host."""
    return t / torch.full((), v, dtype=t.dtype, device=t.device)


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


def _detector_cols(sq: torch.Tensor, c: int, sample_rate: float,
                   threshold_db: float, ratio: float, attack_ms: float):
    """The detector along axis 0 of sq [L, ...], the per-frame sums of
    squares over c channels; every column is a fresh pydub call (its
    window starts empty). Returns (rms, max_att_db, thresh_rms)."""
    look = int(attack_ms * sample_rate / 1000.0)
    wsum = (W.windowed_sum_exclusive(sq, look) if look > 0
            else torch.zeros_like(sq))
    idx = torch.arange(sq.shape[0], device=sq.device) >= look
    return _detector_from_wsum(wsum, float(max(look, 1) * c),
                               idx.reshape((-1,) + (1,) * (sq.ndim - 1)),
                               threshold_db, ratio)


def pydub_detector(x_int: torch.Tensor, sample_rate: float,
                   threshold_db: float, ratio: float,
                   attack_ms: float = 5.0):
    """Per-frame integer RMS + max-attenuation, pydub conventions.
    x_int: [N, C] int16-valued float32. Returns (rms, max_att_db,
    thresh_rms) with rms and max_att [N]."""
    return _detector_cols(torch.sum(x_int * x_int, dim=1), x_int.shape[1],
                          sample_rate, threshold_db, ratio, attack_ms)


def _max_att_chunked(x_int: torch.Tensor, sample_rate: float,
                     threshold_db: float, ratio: float, chunk_len: int,
                     attack_ms: float) -> torch.Tensor:
    """The detector's max-attenuation [N] with its window restarted at
    every chunk (rms 0 for the first ``look`` samples of each): the chunks
    run as columns [chunk_len, n_chunks]."""
    n, c = x_int.shape
    nc = -(-n // chunk_len)
    sq = torch.nn.functional.pad(torch.sum(x_int * x_int, dim=1),
                                 (0, nc * chunk_len - n))
    m = _detector_cols(sq.reshape(nc, chunk_len).T.contiguous(), c,
                       sample_rate, threshold_db, ratio, attack_ms)[1]
    return m.T.reshape(-1)[:n]


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


def pydub_compress_exact_multi_chunked(bands, sample_rate: float, threshs,
                                       ratios, chunk_len: int,
                                       attack_ms: float = 5.0,
                                       release_ms: float = 50.0):
    """Chunked-compat exact compression (quirk Q6): the detector window and
    the gain state both restart at every ``chunk_len`` boundary, as a fresh
    pydub call per chunk would. bands: list of [N, C]; returns a list."""
    ms = [_max_att_chunked(band, sample_rate, float(threshs[i]),
                           float(ratios[i]), chunk_len, attack_ms)
          for i, band in enumerate(bands)]
    atts = pydub_gain_chunked(ms, attack_ms * sample_rate / 1000.0,
                              release_ms * sample_rate / 1000.0, chunk_len)
    return [_apply_attenuation_int(bands[g], atts[g])
            for g in range(len(bands))]


# ---------------------------------------------------------------------------
# Fast associative path (clamped-accumulator algebra)
# ---------------------------------------------------------------------------

def _clip_combine(e1, e2):
    """Compose f1 then f2 where f(g) = min(hi, max(lo, g + d)), lo <= hi.

    f2(f1(g)) = min(hi', max(lo', g + d1 + d2)) with
      hi' = min(h2, max(l2, h1 + d2))   (= median(l2, h1+d2, h2))
      lo' = max(l2, l1 + d2), re-clamped to hi' so a degenerate
            composition (lo > hi == constant function) stays canonical.
    Exact function composition, so associative."""
    d1, lo1, hi1 = e1
    d2, lo2, hi2 = e2
    hi = torch.minimum(hi2, torch.maximum(lo2, hi1 + d2))
    lo = torch.minimum(torch.maximum(lo2, lo1 + d2), hi)
    return d1 + d2, lo, hi


def _pydub_gain_fast(above: torch.Tensor, max_att: torch.Tensor,
                     attack_frames: float,
                     release_frames: float) -> torch.Tensor:
    """The pydub gain recurrence with the branch taken from the detector
    (``above``: rms over the threshold) instead of the state: an attacking
    step is clip(g + m/attack, 0, m), a releasing one clip(g - m/release,
    0, inf). Each step is a clip map, and clip maps compose
    (``_clip_combine``), so the walk is a blocked Kogge-Stone scan over
    blocks of up to 2^16 samples plus a sequential carry over the block
    ends. max_att [N] -> att [N]."""
    inc = _div(max_att, attack_frames)
    dec = _div(max_att, release_frames)
    inf = float("inf")
    d = torch.where(above, inc, -dec)
    lo = torch.zeros_like(max_att)
    hi = torch.where(above, max_att, torch.full_like(max_att, inf))

    n = d.shape[0]
    L = 1 << min(16, max(n - 1, 1).bit_length())
    nb = -(-n // L)

    def blk(x, fill):
        return torch.nn.functional.pad(x, (0, nb * L - n),
                                       value=fill).reshape(nb, L)

    def shift(x, k, fill):
        return torch.nn.functional.pad(x[:, :L - k], (k, 0), value=fill)

    D, Lo, Hi = blk(d, 0.0), blk(lo, -inf), blk(hi, inf)
    s = 1
    while s < L:
        e1 = (shift(D, s, 0.0), shift(Lo, s, -inf), shift(Hi, s, inf))
        D, Lo, Hi = _clip_combine(e1, (D, Lo, Hi))
        s *= 2
    # the attenuation entering each block (g_{-1} = 0)
    g = max_att.new_zeros(())
    starts = []
    for b in range(nb):
        starts.append(g)
        g = torch.minimum(torch.maximum(g + D[b, -1], Lo[b, -1]), Hi[b, -1])
    Gpre = torch.stack(starts)
    att = torch.minimum(torch.maximum(Gpre[:, None] + D, Lo), Hi)
    return att.reshape(nb * L)[:n]


def pydub_compress_fast(x_int: torch.Tensor, sample_rate: float,
                        threshold_db: float, ratio: float,
                        attack_ms: float = 5.0,
                        release_ms: float = 50.0) -> torch.Tensor:
    """pydub compression of one [N, C] int16-valued band with the
    clamp-approximation gain walk (``_pydub_gain_fast``): associative, no
    sequential loop over samples, and not exact where the state crosses
    the detector's max-attenuation while the detector stays above its
    threshold. Plain torch."""
    rms, max_att, thresh_rms = pydub_detector(
        x_int, sample_rate, threshold_db, ratio, attack_ms)
    att = _pydub_gain_fast(rms > thresh_rms, max_att,
                           attack_ms * sample_rate / 1000.0,
                           release_ms * sample_rate / 1000.0)
    return _apply_attenuation_int(x_int, att)


# ---------------------------------------------------------------------------
# Quality path: smooth decoupled detector, no sequential loop
# ---------------------------------------------------------------------------

def compress_quality_multi(bands, sample_rate: float, thresholds_db, ratios,
                           attack_ms: float = 5.0, release_ms: float = 50.0,
                           rms_ms: float = 5.0):
    """Compress G bands at once: the windowed-RMS level, the release scan
    and the attack smoother each run once on [N, G] (one attack and release
    for all bands; thresholds and ratios per band: G floats or a [G]
    tensor). The smoother is a k=1 cascade over the G columns. bands: list
    of G [N, C]; returns the list of compressed bands.

    Differentiable in the bands and in tensor thresholds and ratios: the
    level and the gain computer are torch ops, the release scan is a
    (max, x) Kogge-Stone in torch ops, and the smoother goes through
    ``sosfilt`` (``SosfiltFn`` on the card)."""
    G = len(bands)
    dt, dev = bands[0].dtype, bands[0].device
    rms_w = max(int(rms_ms * sample_rate / 1000.0), 1)
    sq = torch.stack([torch.mean(b * b, dim=1) for b in bands], dim=1)
    level_db = 10.0 * torch.log10(torch.clamp(W.moving_mean_past(sq, rms_w),
                                              min=1e-12))
    th = torch.as_tensor(thresholds_db, dtype=dt, device=dev).reshape(1, G)
    ra = torch.as_tensor(ratios, dtype=dt, device=dev).reshape(1, G)
    gr_db = torch.clamp(level_db - th, min=0.0) * (1.0 - 1.0 / ra)
    gr_rel = W.release_scan(
        gr_db, math.exp(-1.0 / (release_ms * sample_rate / 1000.0)))
    gr_smooth, _ = sosfilt(attack_sos(sample_rate, attack_ms),
                           gr_rel.contiguous())
    gains = 10.0 ** (-gr_smooth / 20.0)
    return [bands[g] * gains[:, g:g + 1] for g in range(G)]


def attack_sos(sample_rate: float, attack_ms: float) -> np.ndarray:
    """The one-pole attack smoother as a k=1 cascade [1, 6], coefficients
    rounded to f32 as the reference's traced ones are."""
    a = math.exp(-1.0 / (attack_ms * sample_rate / 1000.0))
    return np.asarray([[1.0 - a, 0.0, 0.0, 1.0, -a, 0.0]], np.float32)


def compress_quality(x: torch.Tensor, sample_rate: float, threshold_db,
                     ratio, attack_ms: float = 5.0, release_ms: float = 50.0,
                     rms_ms: float = 5.0, makeup_db: float = 0.0):
    """Feed-forward RMS compressor with smooth decoupled attack/release.
    x: [N, C] float in [-1, 1]; gain shared across channels."""
    (y,) = compress_quality_multi([x], sample_rate, [threshold_db], [ratio],
                                  attack_ms, release_ms, rms_ms)
    return y * float(np.float32(10.0) ** (np.float32(makeup_db)
                                          / np.float32(20.0)))
