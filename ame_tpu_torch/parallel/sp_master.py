"""Sequence-parallel quality mastering: one track sharded over a mesh's time
axis (port of ``ame_tpu/parallel/sp_master.py``).

The track's rows are split into D equal shards, shard i on the axis's
device i (``parallel/mesh.py``); every stage runs its per-shard work in a
loop over the shards and moves only small cross-shard tensors between
devices. Per stage (quality mode):

  * analog drive (tanh) and stereo width: memoryless, shard-local;
  * analog shelves + 4-band RBJ EQ: one host-designed cascade of 6
    sections (``_pre_cascade_sos``) through the exact sequence-parallel IIR
    (``parallel/sequence.py``: a zero-state K5 launch a shard, the shards'
    end states composed on the first device, the zero-input response from
    each inbound state added to its shard);
  * multiband (``_multiband_sp``): each band's cascade through the sp IIR,
    the RMS detector shard-local with a left halo and the global
    start-clipped divisor, the release scan shard-local with an exact
    cross-shard (max, x) carry from the gathered shard ends, the attack
    smoother through the sp IIR again;
  * loudness: K-weighting through the sp IIR, 100 ms hop energies summed
    shard-locally and gathered for the BS.1770 gate math
    (``ops.loudness.gated_stats_from_hops``); the true peak per shard with
    a 128-sample left halo (the 4x interpolator is causal), then a max;
  * lookahead limiter (``_limiter_sharded``): each shard limits (left
    warm-up halo | shard | right lookahead halo; the first shard takes no
    left halo, the last a zero right one) and keeps its own span; the
    release state converges over the left halo as rho^h (1 s at the 50 ms
    release is ~e^-20), so the limiter is exact up to that term and every
    other stage is exact up to f32 rounding.

The port runs eagerly, so ``ame_tpu``'s whole-chain program cache has no
counterpart. ``settings.mode == "compat"`` goes to ``parallel/sp_compat.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ame_tpu_torch import config as C
from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import eq, saturate, stereo
from ame_tpu_torch.ops import loudness as L
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.compressor import attack_sos
from ame_tpu_torch.ops.limiter import lookahead_limiter
from ame_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from ame_tpu_torch.parallel.sequence import sosfilt_shards


def _pre_cascade_sos(s, sample_rate: float) -> np.ndarray:
    """Host-designed SOS for the LTI part of the pre stage: the analog
    shelves (when analog_character > 0) followed by the 4-band quality EQ,
    the one-device chain's designs (``ops/saturate.analog_sos``,
    ``ops/eq.eq_quality_sos``) in one cascade."""
    fs = float(sample_rate)
    analog = ([saturate.analog_sos(fs, float(s.analog_character))]
              if s.analog_character else [])
    return np.concatenate(analog + [eq.eq_quality_sos(
        fs, float(s.bass_boost), float(s.mid_cut), float(s.presence_boost),
        float(s.treble_boost))])


def _left_halo(parts: list, h: int) -> list:
    """Per shard, the [h, ...] tail of its LEFT neighbour (zeros for the
    first shard), on the shard's device."""
    out = [parts[0].new_zeros((h,) + tuple(parts[0].shape[1:]))]
    for prev, p in zip(parts[:-1], parts[1:]):
        out.append(prev[prev.shape[0] - h:].to(p.device))
    return out


def _right_halo(parts: list, h: int) -> list:
    """Per shard, the [h, ...] head of its RIGHT neighbour (zeros for the
    last shard), on the shard's device."""
    out = [nxt[:h].to(p.device) for p, nxt in zip(parts[:-1], parts[1:])]
    return out + [parts[-1].new_zeros((h,) + tuple(parts[-1].shape[1:]))]


def _true_peak_sharded(parts: list, n_valid=None) -> torch.Tensor:
    """The global 4x-oversampled true peak of sharded [N, C], exact up to
    f32 summation order: each shard's tiles get the 128-sample tail of the
    shard before as history. ``n_valid`` masks the interpolants and
    samples of trailing padding. Returns a 0-d tensor on the first shard's
    device."""
    Lb = L._TP_LB
    if n_valid is None:
        n_valid = sum(p.shape[0] for p in parts)
    peaks, base = [], 0
    for p, halo in zip(parts, _left_halo(parts, Lb)):
        n, c = p.shape
        M = L._tp_matrix(p.device)
        nb = -(-n // Lb)
        ext = torch.cat([halo, F.pad(p, (0, 0, 0, nb * Lb - n))])
        xt = ext.reshape(nb + 1, Lb, c)
        xcat = L._bf16_round(torch.cat([xt[:-1], xt[1:]], dim=1))
        out = torch.einsum("vu,buc->bvc", M, xcat)
        t_in_tile = torch.arange(M.shape[0], device=p.device) % Lb
        pos = (torch.arange(nb, device=p.device)[:, None] * Lb
               + t_in_tile[None, :])
        local_end = min(int(n_valid) - base, n)
        valid = (pos < local_end)[:, :, None]
        samp_ok = (torch.arange(n, device=p.device) < local_end)[:, None]
        peaks.append(torch.maximum(
            torch.amax(torch.where(valid, out.abs(), torch.zeros_like(out))),
            torch.amax(torch.where(samp_ok, p.abs(), torch.zeros_like(p)))))
        base += n
    dev0 = parts[0].device
    return torch.stack([q.to(dev0) for q in peaks]).amax()


def _limiter_sharded(parts: list, sample_rate: float,
                     halo_s: float) -> list:
    """Lookahead limiter on sharded [N, C]: each shard limits (left warm-up
    halo | shard | right lookahead halo) and keeps its own span. The left
    halo bounds the release-state mismatch by rho^(halo - attack), ~e^-20
    at the defaults; the right halo (2x the attack window) holds every
    lookahead sample the shard's last window reads. The first shard takes
    no left halo (``ame_tpu`` gives it zeros, whose unit gains enter its
    first attack window's mean), so the track's start is the one-device
    limiter's exactly."""
    def limit(x):
        return lookahead_limiter(x, sample_rate, C.LIMITER_CEILING,
                                 C.LIMITER_ATTACK_MS, C.LIMITER_RELEASE_MS)

    if len(parts) == 1:
        # the halos would be zeros: a zero warm-up is the fresh limiter
        # state and a zero lookahead the one-device end of the track
        return [limit(parts[0])]
    attack = max(int(C.LIMITER_ATTACK_MS * sample_rate / 1000.0), 1)
    local_n = parts[0].shape[0]
    halo_l = min(max(int(halo_s * sample_rate), 4 * attack), local_n)
    halo_r = min(2 * attack, local_n)
    out = []
    for s, (p, hl, hr) in enumerate(zip(parts, _left_halo(parts, halo_l),
                                        _right_halo(parts, halo_r))):
        # the first shard starts the track: no warm-up, so its attack
        # ramp's mean is start-clipped as the one-device limiter's is
        h = 0 if s == 0 else halo_l
        ext = torch.cat([hl[halo_l - h:], p, hr])
        out.append(limit(ext)[h:h + p.shape[0]])
    return out


def _multiband_params(settings, sample_rate: float):
    """Band cascades and per-band (threshold, ratio) tuples for the sp
    multiband stage: the 3-band split's cascades of the one-device chain
    (``graph/multiband._band_cascades_3``), or with ``mb_edges`` the
    allpass-compensated G-band tree."""
    from ame_tpu_torch.graph import multiband as mb
    fs = float(sample_rate)
    if settings.mb_edges is not None:
        cascades = mb._band_cascades_n(fs, tuple(settings.mb_edges))
        G = len(cascades)
        th = settings.mb_thresholds or (-20.0,) * G
        ra = settings.mb_ratios or (3.0,) * G
        return cascades, tuple(th), tuple(ra)
    th = (settings.low_thresh, settings.mid_thresh, settings.high_thresh)
    ra = (settings.low_ratio, settings.mid_ratio, settings.high_ratio)
    return mb._band_cascades_3(fs), th, ra


def _carry_weights(D: int, local_n: int, decay: float) -> np.ndarray:
    """[D, D] float64: w[s, j] = decay^((s-1-j)·local_n) for j < s, else 0
    — the unrolled boundary recurrence of a (max, x) scan: the carry into
    shard s is max_j w[s, j]·e_j over the shards' zero-state ends e_j."""
    s = np.arange(D)[:, None]
    j = np.arange(D)[None, :]
    dist = np.maximum(s - 1 - j, 0).astype(np.float64) * local_n
    return np.where(j < s, np.exp(dist * math.log(decay)), 0.0)


def _scan_carry(locs: list, decay: float) -> list:
    """Exact cross-shard carry of the (max, x) scan y[n] = max(u[n],
    decay·y[n-1]) run shard-locally from zero state: ``locs`` the shards'
    zero-state scans [Ln, ...]; each shard s > 0 takes max(y_loc,
    c_s·decay^k), k = 1 .. Ln, with c_s from the gathered shard ends."""
    D = len(locs)
    if D == 1:
        return locs
    dev0 = locs[0].device
    local_n = locs[0].shape[0]
    ends = torch.stack([y[-1].to(dev0) for y in locs])        # [D, ...]
    w = torch.tensor(_carry_weights(D, local_n, decay), dtype=ends.dtype,
                     device=dev0)
    wb = w.reshape((D, D) + (1,) * (ends.ndim - 1))
    carry = torch.amax(wb * ends[None], dim=1)                # [D, ...]
    out = [locs[0]]
    for s in range(1, D):
        y = locs[s]
        k = torch.arange(1, local_n + 1, dtype=y.dtype, device=y.device)
        kpow = torch.exp(k * math.log(decay)).reshape(
            (local_n,) + (1,) * (y.ndim - 1))
        out.append(torch.maximum(y, carry[s].to(y.device)[None] * kpow))
    return out


def _multiband_sp(parts: list, sample_rate: float, settings) -> list:
    """Quality multiband compression of sharded [N, C]: the bands through
    the sp IIR (a K5 launch a band piece a shard, plus the zero-input
    responses), the RMS detector shard-local with an (rms_w - 1)-sample
    left halo and the global start-clipped divisor, the release scan with
    its exact cross-shard carry (``_scan_carry``), the attack smoother
    through the sp IIR, gains applied and bands summed shard-locally.
    Matches ``ops.compressor.compress_quality_multi`` to f32 rounding."""
    cascades, th, ra = _multiband_params(settings, sample_rate)
    G = len(cascades)
    local_n = parts[0].shape[0]
    rms_w = max(int(C.MB_RMS_MS * sample_rate / 1000.0), 1)
    rel_decay = math.exp(-1.0 / (C.MB_RELEASE_MS * sample_rate / 1000.0))

    bands = [sosfilt_shards(sos_g, parts) for sos_g in cascades]  # [G][D]
    sqs = [torch.stack([torch.mean(bands[g][s] * bands[g][s], dim=1)
                        for g in range(G)], dim=1)
           for s in range(len(parts))]                            # [Ln, G]
    halos = _left_halo(sqs, rms_w - 1) if rms_w > 1 else None
    locs = []
    for s, sq in enumerate(sqs):
        dt, dev = sq.dtype, sq.device
        if rms_w > 1:
            ssum = W.moving_sum_past(torch.cat([halos[s], sq]),
                                     rms_w)[rms_w - 1:]
        else:
            ssum = sq
        gidx = s * local_n + torch.arange(local_n, device=dev)
        count = torch.clamp(gidx + 1, max=rms_w).to(dt)
        level_db = 10.0 * torch.log10(torch.clamp(ssum / count[:, None],
                                                  min=1e-12))
        th_t = torch.tensor(th, dtype=dt, device=dev).reshape(1, G)
        ra_t = torch.tensor(ra, dtype=dt, device=dev).reshape(1, G)
        gr = torch.clamp(level_db - th_t, min=0.0) * (1.0 - 1.0 / ra_t)
        locs.append(W.release_scan(gr, rel_decay))
    gr_rel = _scan_carry(locs, rel_decay)
    gr_smooth = sosfilt_shards(attack_sos(sample_rate, C.MB_ATTACK_MS),
                               [g.contiguous() for g in gr_rel])
    out = []
    for s, gs in enumerate(gr_smooth):
        gains = 10.0 ** (-gs / 20.0)
        y = bands[0][s] * gains[:, 0:1]
        for g in range(1, G):
            y = y + bands[g][s] * gains[:, g:g + 1]
        out.append(y)
    return out


def _hop_energies(parts: list, hop: int) -> torch.Tensor:
    """[n_hops] 100 ms hop energies (squares summed over channels) of
    sharded K-weighted audio whose shards hold whole hops, gathered on the
    first shard's device."""
    dev0 = parts[0].device
    return torch.cat([torch.sum(torch.sum(y * y, dim=1).reshape(-1, hop),
                                dim=1).to(dev0) for y in parts])


def _quality_shards(parts: list, n_valid: int, settings,
                    sample_rate: float, limiter_halo_s: float):
    """The whole quality chain on shards -> (shards, info)."""
    hop = int(round(0.100 * sample_rate))
    info = {}
    if settings.analog_character:
        parts = [saturate.analog_drive(p, float(settings.analog_character))
                 for p in parts]
    parts = sosfilt_shards(_pre_cascade_sos(settings, sample_rate), parts)
    if settings.width != 1.0:
        parts = [stereo.stereo_width_quality(p, float(settings.width))
                 for p in parts]
    if settings.multiband or settings.mb_edges is not None:
        parts = _multiband_sp(parts, sample_rate, settings)
    if settings.lufs is not None:
        yk = sosfilt_shards(design.k_weighting_sos(sample_rate), parts)
        integrated, lra, rel_thresh = L.gated_stats_from_hops(
            _hop_energies(yk, hop), hop, n_valid)
        tp = 20.0 * torch.log10(torch.clamp(
            _true_peak_sharded(parts, n_valid), min=1e-12))
        gain_db = float(settings.lufs) - integrated
        gain_db = torch.where(torch.isfinite(integrated), gain_db,
                              torch.zeros_like(gain_db))
        g = 10.0 ** (gain_db / 20.0)
        parts = [p * g.to(p.device) for p in parts]
        info = {"input_i": integrated, "input_lra": lra, "input_tp": tp,
                "input_thresh": rel_thresh, "gain_db": gain_db,
                "output_i": integrated + gain_db,
                "linear_mode": torch.ones((), device=integrated.device)}
    return _limiter_sharded(parts, sample_rate, limiter_halo_s), info


def _check_n_valid(n_valid, n: int) -> int:
    if n_valid is None:
        return n
    if isinstance(n_valid, torch.Tensor) or not isinstance(
            n_valid, (int, np.integer)):
        raise ValueError("sequence-parallel mastering needs a concrete "
                         "(host int) n_valid")
    return int(n_valid)


def master_sequence_parallel(x, sample_rate: float, settings, mesh: Mesh,
                             axis: str = "sp", limiter_halo_s: float = 1.0,
                             n_valid=None):
    """Master ONE [N, 2] track with the time axis sharded over ``mesh``'s
    ``axis`` (shard i on the axis's device i).

    Requirements: N divisible by the axis size and, when loudness
    normalization is on, each shard a whole number of 100 ms hops. Other
    lengths: zero-pad to those granules and pass the true length as
    ``n_valid`` (a host int), which masks the loudness gate and the true
    peak as the one-device chain's ``n_valid`` does
    (``master_sequence_parallel_padded`` does both). Compat settings go to
    ``sp_compat.master_compat_sequence_parallel``.

    Returns (y, info): the mastered [N, 2] gathered on the axis's first
    device, and the info of ``ops.loudness.normalize_two_pass`` (0-d
    tensors; empty without loudness normalization)."""
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    if settings.mode == "compat":
        from ame_tpu_torch.parallel.sp_compat import (
            master_compat_sequence_parallel)
        return master_compat_sequence_parallel(x, sample_rate, settings,
                                               mesh, axis=axis,
                                               n_valid=n_valid)
    if settings.mode != "quality":
        raise ValueError(f"unknown mode {settings.mode!r}")
    ndev = mesh.shape[axis]
    n = x.shape[0]
    if n % ndev:
        raise ValueError(f"N={n} not divisible by {ndev} shards")
    local_n = n // ndev
    hop = int(round(0.100 * sample_rate))
    if settings.lufs is not None and local_n % hop:
        raise ValueError(
            f"shard length {local_n} must be a multiple of the 100 ms "
            f"gating hop ({hop} samples) when lufs is set")
    nv = _check_n_valid(n_valid, n)
    precision.apply()
    parts = shard_rows(torch.as_tensor(x, dtype=torch.float32), mesh, axis)
    parts, info = _quality_shards(parts, nv, settings, float(sample_rate),
                                  float(limiter_halo_s))
    return gather_rows(parts), info


def master_sequence_parallel_padded(x, sample_rate: float, settings,
                                    mesh: Mesh, axis: str = "sp",
                                    limiter_halo_s: float = 1.0):
    """Arbitrary-length front end for ``master_sequence_parallel``:
    zero-pads to the shard / hop (chunked compat: shard / 30 s chunk)
    granule, masks the measurement with the true length, and trims the
    output back to the input length."""
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    ndev = mesh.shape[axis]
    hop = int(round(0.100 * sample_rate))
    unit = hop if settings.lufs is not None else 1
    if settings.mode == "compat" and settings.compat_chunked:
        # chunked compat shards own whole 30 s chunks (the Q6 resets make
        # the DSP stages shard-local); the chunk is a hop multiple
        unit = int(C.COMPAT_CHUNK_SECONDS * sample_rate)
    granule = ndev * unit
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    n_pad = -(-n // granule) * granule
    xp = F.pad(x, (0, 0, 0, n_pad - n))
    y, info = master_sequence_parallel(
        xp, sample_rate, settings, mesh, axis=axis,
        limiter_halo_s=limiter_halo_s, n_valid=n)
    return y[:n], info
