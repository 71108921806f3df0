"""Channel-stacked fleet mastering: B tracks as ONE [N, 2B] signal (port of
``ame_tpu/parallel/stacked.py``).

Track b owns columns 2b and 2b + 1, so every filter, window and scan runs
once on one wide signal: each cascade of the quality chain is one K5
launch at C = 2B (the attack smoother at C = 3B) instead of B launches at
C = 2, as ``parallel/batch.master_batch`` makes them. Only the stages with
per-track (stereo-pair) semantics get track-halved forms here: the width,
the multiband detector, the loudness gate, the true peak and the limiter's
channel link. The per-sample and per-column stages (saturation, EQ, the
crossovers) are the port's own, unchanged.

Quality chain only, as in ``ame_tpu``. Where ``ame_tpu`` stacks on the
host (a TPU relayout of [B, N, 2] is slow), the port stacks with a
``permute`` and ``reshape`` on the device. ``measure_stacked``'s true peak
is ``ame_tpu``'s: float32 operands, every interpolant of the padded tail
included (the single-track ``loudness.true_peak`` rounds to bf16 and masks
the tail); the chain uses only its loudness.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ame_tpu_torch import config as C
from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.device import resolve_device
from ame_tpu_torch.dsp import design
from ame_tpu_torch.graph.chain import params_from_settings
from ame_tpu_torch.graph.multiband import quality_band_split
from ame_tpu_torch.ops import eq, saturate
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.compressor import attack_sos
from ame_tpu_torch.ops.loudness import (_TP_LB, _block_sums,
                                        _power_to_lufs, _tp_tile_matrix)
from ame_tpu_torch.ops.scan_iir import sosfilt


def _pair_sum_sq(x2b: torch.Tensor) -> torch.Tensor:
    """[N, 2B] -> per-track channel-summed square [N, B]."""
    n, c2 = x2b.shape
    return (x2b * x2b).reshape(n, c2 // 2, 2).sum(dim=2)


def _per_pair(g_b: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-track [..., B] gain to [..., 2B] columns."""
    return torch.repeat_interleave(g_b, 2, dim=-1)


def stereo_width_stacked(x2b: torch.Tensor, width) -> torch.Tensor:
    """Mid/side width of each track (``stereo.stereo_width_quality``: no
    clip) on [N, 2B]."""
    n, c2 = x2b.shape
    p = x2b.reshape(n, c2 // 2, 2)
    mid = (p[:, :, 0] + p[:, :, 1]) * 0.5
    side = (p[:, :, 0] - p[:, :, 1]) * 0.5 * width
    return torch.stack([mid + side, mid - side], dim=2).reshape(n, c2)


def compress_quality_multi_stacked(bands, sample_rate: float, thresholds_db,
                                   ratios, attack_ms: float = 5.0,
                                   release_ms: float = 50.0,
                                   rms_ms: float = 5.0):
    """G bands of [N, 2B] stacked tracks: the detector, the release scan
    and the attack smoother run once on [N, G·B] (column g·B + b is band g
    of track b), so tracks and bands share every pass; thresholds and
    ratios per band (G floats or a [G] tensor). Returns the G compressed
    bands."""
    G = len(bands)
    c2 = bands[0].shape[1]
    B = c2 // 2
    dt, dev = bands[0].dtype, bands[0].device
    rms_w = max(int(rms_ms * sample_rate / 1000.0), 1)
    # the channel mean of the square, as the single-track detector's
    sq = torch.cat([_pair_sum_sq(b) * 0.5 for b in bands], dim=1)
    level_db = 10.0 * torch.log10(torch.clamp(W.moving_mean_past(sq, rms_w),
                                              min=1e-12))
    th = torch.as_tensor(thresholds_db, dtype=dt, device=dev)
    ra = torch.as_tensor(ratios, dtype=dt, device=dev)
    th = torch.repeat_interleave(th, B).reshape(1, G * B)
    ra = torch.repeat_interleave(ra, B).reshape(1, G * B)
    gr_db = torch.clamp(level_db - th, min=0.0) * (1.0 - 1.0 / ra)
    gr_rel = W.release_scan(
        gr_db, math.exp(-1.0 / (release_ms * sample_rate / 1000.0)))
    gr_smooth, _ = sosfilt(attack_sos(sample_rate, attack_ms),
                           gr_rel.contiguous())
    gains = 10.0 ** (-gr_smooth / 20.0)
    return [bands[g] * _per_pair(gains[:, g * B:(g + 1) * B])
            for g in range(G)]


def multiband_quality_stacked(x2b: torch.Tensor, sample_rate: float, threshs,
                              ratios) -> torch.Tensor:
    """The quality 3-band stage on [N, 2B]: one LR4 cascade a band over
    every track, the stacked compressor, a flat sum."""
    low, mid, high = quality_band_split(x2b, sample_rate)
    comp = compress_quality_multi_stacked(
        [low, mid, high], sample_rate, threshs, ratios,
        attack_ms=C.MB_ATTACK_MS, release_ms=C.MB_RELEASE_MS,
        rms_ms=C.MB_RMS_MS)
    return comp[0] + comp[1] + comp[2]


# ---------------------------------------------------------------------------
# Per-track loudness on the stacked layout
# ---------------------------------------------------------------------------

def _block_powers_stacked(y2b: torch.Tensor, sample_rate: float,
                          block_s: float, hop_s: float) -> torch.Tensor:
    """[N, 2B] K-weighted audio -> per-track gating-block powers
    [n_blocks, B] (BS.1770's channel sum of per-channel mean squares)."""
    hop = int(round(hop_s * sample_rate))
    steps = int(round(block_s / hop_s))
    n_hops = y2b.shape[0] // hop
    sq = _pair_sum_sq(y2b)                                   # [N, B]
    hop_sums = sq[:n_hops * hop].reshape(n_hops, hop, -1).sum(dim=1)
    return _block_sums(hop_sums, steps) / (hop * steps)


def measure_stacked(x2b: torch.Tensor, sample_rate: float):
    """Per-track (integrated LUFS [B], 4x true peak dB [B]) of [N, 2B];
    a track with no gated block reads -inf (quirk Q9)."""
    y, _ = sosfilt(design.k_weighting_sos(sample_rate), x2b)
    p = _block_powers_stacked(y, sample_rate, 0.400, 0.100)  # [nb, B]
    lv = _power_to_lufs(p)
    abs_m = lv > -70.0
    zero = torch.zeros_like(p)
    cnt = torch.clamp(abs_m.sum(dim=0), min=1)
    mean_abs = torch.where(abs_m, p, zero).sum(dim=0) / cnt
    rel = _power_to_lufs(mean_abs) - 10.0
    gate = abs_m & (lv > rel[None])
    gcnt = torch.clamp(gate.sum(dim=0), min=1)
    gp = torch.where(gate, p, zero).sum(dim=0) / gcnt
    integ = torch.where(torch.any(gate, dim=0), _power_to_lufs(gp),
                        torch.full_like(gp, -math.inf))

    # per-track 4x true peak through the tile matrix, in float32
    n, c2 = x2b.shape
    Lb = _TP_LB
    nb = -(-n // Lb)
    xt = F.pad(x2b, (0, 0, Lb, nb * Lb - n)).reshape(nb + 1, Lb, c2)
    xcat = torch.cat([xt[:-1], xt[1:]], dim=1)               # [nb, 2Lb, 2B]
    M = torch.from_numpy(_tp_tile_matrix()).to(x2b.device, x2b.dtype)
    os4 = torch.einsum("vu,buc->bvc", M, xcat)               # [nb, 4Lb, 2B]
    pk = torch.amax(os4.abs().reshape(nb, 4 * Lb, c2 // 2, 2), dim=(0, 1, 3))
    pk = torch.maximum(pk, torch.amax(x2b.abs().reshape(n, c2 // 2, 2),
                                      dim=(0, 2)))
    return integ, 20.0 * torch.log10(torch.clamp(pk, min=1e-12))


def normalize_stacked(x2b: torch.Tensor, sample_rate: float,
                      target_lufs: float) -> torch.Tensor:
    """Per-track two-pass linear normalization (the quality chain's clean
    gain); a silent track passes through (quirk Q9)."""
    integ, _ = measure_stacked(x2b, sample_rate)
    gain_db = torch.where(torch.isfinite(integ), target_lufs - integ,
                          torch.zeros_like(integ))          # [B]
    return x2b * _per_pair(10.0 ** (gain_db / 20.0))[None]


def limiter_stacked(x2b: torch.Tensor, sample_rate: float,
                    ceiling: float = C.LIMITER_CEILING,
                    attack_ms: float = C.LIMITER_ATTACK_MS,
                    release_ms: float = C.LIMITER_RELEASE_MS) -> torch.Tensor:
    """Per-track channel-linked lookahead limiting on [N, 2B]
    (``limiter.lookahead_limiter``'s semantics, one pass for all B)."""
    n, c2 = x2b.shape
    attack = max(int(attack_ms * sample_rate / 1000.0), 1)
    decay = math.exp(-1.0 / (release_ms * sample_rate / 1000.0))
    peak = torch.amax(x2b.abs().reshape(n, c2 // 2, 2), dim=2)  # [N, B]
    g_t = torch.clamp(ceiling / torch.clamp(peak, min=1e-9), max=1.0)
    g_a = W.sliding_min_ahead(g_t, attack)
    g_r = W.moving_mean_past(g_a, attack)
    u = W.release_scan(1.0 - g_r, decay)
    return x2b * _per_pair(1.0 - u)


# ---------------------------------------------------------------------------
# The stacked batch graph
# ---------------------------------------------------------------------------

def _stacked(x2b, p, sample_rate, analog_on, width_on, multiband_on,
             lufs_on):
    if analog_on:
        x2b = saturate.analog_character_quality(x2b, sample_rate,
                                                p["analog"])
    x2b = eq.apply_eq_quality(x2b, sample_rate, p["bass"], p["mid_cut"],
                              p["presence"], p["treble"])
    if width_on:
        x2b = stereo_width_stacked(x2b, p["width"])
    if multiband_on:
        x2b = multiband_quality_stacked(x2b, sample_rate, p["threshs"],
                                        p["ratios"])
    if lufs_on:
        x2b = normalize_stacked(x2b, sample_rate, p["lufs"])
    return limiter_stacked(x2b, sample_rate)


def master_batch_stacked(xs, sample_rate: float, settings,
                         device="cuda") -> torch.Tensor:
    """Master B same-length tracks as one channel-stacked signal, in
    quality mode whatever the settings' mode.

    Args:
      xs: [B, N, 2] or [N, 2B] float32 (tensor or numpy).
      settings: MasterSettings or reference settings dict; ``mb_edges``
        (G-band multiband) raises ``NotImplementedError``.
      device: "cuda" (default; raises without a card) or "cpu", which runs
        the plain PyTorch versions of the kernels.

    Returns the mastered tracks in the shape they came in, on ``device``."""
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    if settings.mb_edges is not None:
        raise NotImplementedError("G-band multiband is not implemented for "
                                  "the channel-stacked layout (use "
                                  "parallel.batch.master_batch)")
    dev = resolve_device(device, "master_batch_stacked")
    xs = torch.as_tensor(xs, dtype=torch.float32).to(dev)
    batched_in = xs.ndim == 3
    if batched_in:
        b, n, _ = xs.shape
        x2b = xs.permute(1, 0, 2).reshape(n, 2 * b)
    else:
        x2b = xs
    precision.apply()
    y = _stacked(x2b, params_from_settings(settings, dev), float(sample_rate),
                 settings.analog_character > 0, settings.width != 1.0,
                 bool(settings.multiband), settings.lufs is not None)
    if batched_in:
        return y.reshape(n, b, 2).permute(1, 0, 2).contiguous()
    return y
