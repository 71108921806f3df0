"""Sequence-parallel COMPAT mastering (port of
``ame_tpu/parallel/sp_compat.py``): the reference-semantics chain
(audio_mastering_engine.py:185-223 — analog character -> EQ -> width ->
multiband -> loudnorm -> alimiter, with the Appendix-A quirks) on one track
sharded over a mesh's time axis (``parallel/mesh.py``).

Per stage:

  * ``compat_chunked=True``: each shard owns whole 30 s chunks, and the
    reference's chunk resets (quirk Q6) make analog / EQ / width /
    multiband exactly shard-local: the one-device chain's stages run on
    each shard with no traffic (``_pre_stages_chunked``);
  * unchunked EQ: each quirk filter's cascade through the exact
    sequence-parallel IIR (``parallel/sequence.py``), the Q1-Q3 blends and
    the int16 round trips shard-local (``_pre_stages_unchunked``); a band
    whose gain is 0 is skipped, as the reference skips it;
  * unchunked multiband (``_multiband_compat_sp``): the subtractive
    crossover through the sp IIR, the integer-RMS detector shard-local
    with a ``look``-sample left halo and global index gating, and the
    exact pydub gain across shards by carry relaxation
    (``_pydub_gain_sp``);
  * loudnorm two-pass (``_loudnorm_measure``, ``_loudnorm_dynamic_apply``):
    per-frame K-weighted moments shard-local, the [F] frame vectors
    gathered on the first device, where the controller
    (``ops.loudnorm._controller_gains``) runs once; per-frame gains apply
    shard-locally. Pass 1's tail double count is emulated on the hop grid
    (exact for hop-aligned lengths);
  * alimiter (``_alimiter_sp``): one shard: ``alimiter_compat`` (K1 in
    both directions). More shards: the 12 tangent-piece (max, x) scans on
    the plain ``window.release_scan``, each with its exact cross-shard
    carry from the gathered shard ends (release left to right, attack
    right to left), as ``ame_tpu`` runs them there: K1 takes no carry in.

``ame_tpu``'s cached XLA programs have no counterpart (the port runs
eagerly); their stage order is kept. One host sync decides the loudnorm
branch (silent / linear / dynamic), as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch import config as C
from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import eq, quantize, saturate, stereo
from ame_tpu_torch.ops import compressor as comp
from ame_tpu_torch.ops import loudness as L
from ame_tpu_torch.ops import loudnorm as LN
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.limiter import _wedge_pieces, alimiter_compat
from ame_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from ame_tpu_torch.parallel.sequence import sosfilt_shards
from ame_tpu_torch.parallel.sp_master import (_check_n_valid, _hop_energies,
                                              _left_halo, _scan_carry,
                                              _true_peak_sharded)

# pydub defaults (the reference call, audio_mastering_engine.py:306-308);
# the eligibility guard derives its detector-window minimum from the same
# constant
_PYDUB_ATTACK_MS = 5.0
_PYDUB_RELEASE_MS = 50.0


def _band_params(settings):
    """The three bands' (threshold, ratio) lists."""
    return ([settings.low_thresh, settings.mid_thresh, settings.high_thresh],
            [settings.low_ratio, settings.mid_ratio, settings.high_ratio])


# ---------------------------------------------------------------------------
# Pre stages (analog -> EQ -> width -> multiband)
# ---------------------------------------------------------------------------

def _pre_stages_chunked(parts: list, settings, sample_rate: float,
                        chunk_len: int, *, analog_on: bool, width_on: bool,
                        multiband_on: bool) -> list:
    """The quirk-faithful pre stages on whole chunks a shard: exact, since
    no state crosses a chunk boundary (Q6); each shard runs the one-device
    chain's stages (``graph/chain._stage_*_compat``) on its own chunks."""
    from ame_tpu_torch.graph import chain as G
    from ame_tpu_torch.graph import multiband as mb
    sr = float(sample_rate)
    threshs, ratios = _band_params(settings)
    out = []
    for y in parts:
        if analog_on:
            y = G._stage_analog_compat(y, float(settings.analog_character),
                                       sr, chunk_len)
        y = G._stage_eq_width_compat(
            y, float(settings.bass_boost), float(settings.mid_cut),
            float(settings.presence_boost), float(settings.treble_boost),
            sr, width_on, float(settings.width), chunk_len)
        if multiband_on:
            y = mb.multiband_compat(y, sr, threshs, ratios,
                                    chunk_len=chunk_len)
        out.append(y)
    return out


def _run_shards(sos, parts: list, blend) -> list:
    """The compat filters' runner on shards (``ops/eq``'s ``run``): the
    cascade through the exact sp IIR, the blend shard-local."""
    return [blend(p, f) for p, f in zip(parts, sosfilt_shards(sos, parts))]


def _pre_stages_unchunked(parts: list, settings, sample_rate: float, *,
                          analog_on: bool, width_on: bool) -> list:
    """Unchunked compat pre stages: the one-device chain's analog and EQ
    stages (``ops/saturate``, ``ops/eq``) with each quirk filter's cascade
    through the exact sp IIR (``_run_shards``), the drive, width and int16
    round trips shard-local. The caller runs ``_multiband_compat_sp`` after
    this when multiband is on."""
    sr = float(sample_rate)

    def rt(parts):
        return [quantize.int16_roundtrip(p) for p in parts]

    if analog_on:
        pct = float(settings.analog_character)
        parts = [saturate.analog_drive(p, pct) for p in parts]
        parts = rt(saturate.analog_shelves_compat(parts, sr, pct,
                                                  run=_run_shards))
    parts = eq.apply_eq_compat(parts, sr, float(settings.bass_boost),
                               float(settings.mid_cut),
                               float(settings.presence_boost),
                               float(settings.treble_boost), run=_run_shards)
    if width_on:
        parts = [stereo.stereo_width(p, float(settings.width))
                 for p in parts]
    return rt(parts)


# ---------------------------------------------------------------------------
# Cross-shard exact pydub gain + unchunked compat multiband
# ---------------------------------------------------------------------------

def _on_devices(fn, m_parts: list, inits: list) -> list:
    """Run ``fn(chains, init)`` once a device over the chains of every
    shard on it (the chains are independent, so a device's shards go
    through one call): m_parts [Ln, G] a shard, inits [G] a shard. Returns
    fn's result a shard, [G, ...]."""
    G = m_parts[0].shape[1]
    by_dev: dict = {}
    for s, m in enumerate(m_parts):
        by_dev.setdefault(m.device, []).append(s)
    out = [None] * len(m_parts)
    for idx in by_dev.values():
        chains = [m_parts[s][:, g] for s in idx for g in range(G)]
        res = fn(chains, torch.cat([inits[s] for s in idx]))
        for i, s in enumerate(idx):
            out[s] = res[i * G:(i + 1) * G]
    return out


def _pydub_gain_sp(m_parts: list, attack_frames: float,
                   release_frames: float) -> list:
    """The exact pydub attenuation across shards: m_parts [Ln, G] a shard
    (the local max-attenuation), returns [Ln, G] a shard.

    The gain recurrence is not associative (``ops/pydub_gain.py``), so
    there is no closed-form boundary carry. Instead, shard-level carry
    relaxation: each sweep runs every shard's exact engine from its
    current inbound guess (``pydub_gain_multi(init=c)``: K2 from a
    non-zero ``init`` on the card, or K3 + K4), and shard s's next guess is
    shard s-1's last state. A sweep is accepted when every guess equals its
    left neighbour's last state bit for bit (one host sync a sweep): then
    c_s = f_{s-1}(c_{s-1}) for all s with c_0 = 0, so the carries are the
    sequential walk's by induction, and that sweep's output is the answer.
    Sweep r runs shards 0 .. r from exact carries, so sweep D - 1 is exact
    and takes no check; real audio converges in 2-3, since the state
    forgets at every full clamp or release. The shards on one device share
    each call."""
    from ame_tpu_torch.ops.pydub_gain import pydub_gain_multi

    D = len(m_parts)
    G = m_parts[0].shape[1]
    c = [m.new_zeros(G) for m in m_parts]

    def full(chains, init):
        return torch.stack(pydub_gain_multi(chains, attack_frames,
                                            release_frames, init=init))

    dev0 = m_parts[0].device
    for r in range(D):
        att = _on_devices(full, m_parts, c)             # [G, Ln] a shard
        if r == D - 1:
            break
        nxt = [c[0]] + [att[s - 1][:, -1].to(m_parts[s].device)
                        for s in range(1, D)]
        same = torch.stack([torch.all(a == b).to(dev0)
                            for a, b in zip(nxt, c)])
        if bool(torch.all(same).item()):
            break
        c = nxt
    return [a.T for a in att]


def _multiband_compat_sp(parts: list, settings,
                         sample_rate: float) -> list:
    """Unchunked compat multiband on sharded audio, exact pydub semantics
    (quirks Q4 / Q5 / Q7 verbatim): the butter LP / HP crossovers through
    the sp IIR, mid = full - low - high (Q4), per-band int16 (Q5); the
    detector's window sum shard-local with a ``look``-sample left halo and
    the track's first ``look`` frames (not each shard's) reading rms 0;
    the gain by ``_pydub_gain_sp``; apply and saturating adds (Q7)
    shard-local."""
    sr = float(sample_rate)
    look = int(_PYDUB_ATTACK_MS * sr / 1000.0)
    a_f = _PYDUB_ATTACK_MS * sr / 1000.0
    r_f = _PYDUB_RELEASE_MS * sr / 1000.0
    threshs, ratios = _band_params(settings)
    lows = sosfilt_shards(design.butter_sos(4, C.MB_LOW_CROSSOVER_HZ,
                                            "lowpass", fs=sr), parts)
    highs = sosfilt_shards(design.butter_sos(4, C.MB_HIGH_CROSSOVER_HZ,
                                             "highpass", fs=sr), parts)
    bands = [[quantize.float_to_int16(b) for b in (lo, x - lo - hi, hi)]
             for x, lo, hi in zip(parts, lows, highs)]       # Q4, Q5
    ln, c = parts[0].shape
    count = float(max(look, 1) * c)
    ms = [[None] * 3 for _ in parts]
    for g in range(3):
        sqs = [torch.sum(b[g] * b[g], dim=1) for b in bands]
        halos = _left_halo(sqs, look) if look > 0 else None
        for s, sq in enumerate(sqs):
            if look > 0:
                wsum = W.moving_sum_past(torch.cat([halos[s], sq]),
                                         look)[look - 1:look - 1 + ln]
            else:
                wsum = torch.zeros_like(sq)
            gidx = s * ln + torch.arange(ln, device=sq.device)
            ms[s][g] = comp._detector_from_wsum(wsum, count, gidx >= look,
                                                threshs[g], ratios[g])[1]
    att = _pydub_gain_sp([torch.stack(m, dim=1) for m in ms], a_f, r_f)
    out = []
    for b, a in zip(bands, att):
        o = [comp._apply_attenuation_int(b[g], a[:, g]) for g in range(3)]
        acc = quantize.saturating_add_int16(o[0], o[1])
        acc = quantize.saturating_add_int16(acc, o[2])       # quirk Q7
        out.append(acc * (1.0 / 32768.0))
    return out


# ---------------------------------------------------------------------------
# Sequence-parallel loudnorm two-pass
# ---------------------------------------------------------------------------

def _frame_gains_shards(parts: list, g0, g1, hop: int) -> list:
    """Per-frame interpolated gains [F] (on the first device) applied to
    each shard's own frames."""
    fl = parts[0].shape[0] // hop
    return [LN.apply_frame_gains(p, g0[s * fl:(s + 1) * fl].to(p.device),
                                 g1[s * fl:(s + 1) * fl].to(p.device), hop)
            for s, p in enumerate(parts)]


def _loudnorm_measure(parts: list, nv: int, *, sr: float, target_i: float,
                      target_tp: float, target_lra: float) -> dict:
    """The pre-branch half of the sp loudnorm two-pass: the frame moments
    (gathered [F]), pass 1's stats with the hop-grid tail double count,
    the true peak, pass 1's dynamic run for target_offset, and the silent
    and linear-mode verdicts. Shards hold whole 100 ms hops."""
    hop = int(round(LN.FRAME_S * sr))
    dev0 = parts[0].device
    F = sum(p.shape[0] for p in parts) // hop
    ndh = int(round(2.9 * sr)) // hop        # 29 hops: the flush re-measure
    ksos = design.k_weighting_dynamic_sos(sr)   # ffmpeg's dynamic meter
    xk = sosfilt_shards(ksos, parts)
    moms = [LN._frame_moments(p, k, hop) for p, k in zip(parts, xk)]
    M0, M1, M2, peak = (torch.cat([m[i].to(dev0) for m in moms])
                        for i in range(4))

    # loudnorm_pass1's tail double count on the hop grid: the last ~2.9 s
    # of hop energies appended at the track end
    nvh = nv // hop
    buf = torch.cat([M0, M0.new_zeros((ndh,))])
    start = min(max(nvh - ndh, 0), F)
    hed = buf.clone()
    hed[min(nvh, F):min(nvh, F) + ndh] = buf[start:start + ndh]
    input_i, input_lra, input_thresh = L.gated_stats_from_hops(
        hed, hop, (nvh + ndh) * hop)
    input_tp = 20.0 * torch.log10(torch.clamp(_true_peak_sharded(parts, nv),
                                              min=1e-12))

    # pass 1's dynamic run: ffmpeg's unmeasured option defaults
    F_eff, blk_valid = LN._valid_frames(F, hop, nv, dev0)
    g0a, g1a = LN._controller_gains(M0, M1, M2, peak, hop, F_eff, blk_valid,
                                    target_i, target_tp, target_lra,
                                    0.0, -70.0, 0.0)
    yk1 = sosfilt_shards(ksos, _frame_gains_shards(parts, g0a, g1a, hop))
    out1_i = L.gated_stats_from_hops(_hop_energies(yk1, hop), hop, nv)[0]

    gain_db = target_i - input_i
    supplied = ((input_tp != 99.0) & (input_thresh != -70.0)
                & (input_lra != 0.0) & (input_i != 0.0))
    lin_ok = (supplied & (input_tp + gain_db <= target_tp)
              & (input_lra <= target_lra))
    return {"M0": M0, "M1": M1, "M2": M2, "peak": peak,
            "input_i": input_i, "input_lra": input_lra,
            "input_tp": input_tp, "input_thresh": input_thresh,
            "target_offset": target_i - out1_i, "gain_db": gain_db,
            "lin_ok": lin_ok, "silent": ~torch.isfinite(input_i)}


def _loudnorm_dynamic_apply(parts: list, nv: int, meas: dict, *, sr: float,
                            target_i: float, target_tp: float,
                            target_lra: float):
    """The dynamic branch: pass 2's controller seeded with the measured
    stats, the gains applied shard-locally, and the output-side stats of
    the actual output. Returns (shards, output_i, output_thresh)."""
    hop = int(round(LN.FRAME_S * sr))
    F = sum(p.shape[0] for p in parts) // hop
    F_eff, blk_valid = LN._valid_frames(F, hop, nv, parts[0].device)
    g0d, g1d = LN._controller_gains(
        meas["M0"], meas["M1"], meas["M2"], meas["peak"], hop, F_eff,
        blk_valid, target_i, target_tp, target_lra, meas["input_i"],
        meas["input_thresh"], meas["target_offset"])
    y = _frame_gains_shards(parts, g0d, g1d, hop)
    yko = sosfilt_shards(design.k_weighting_dynamic_sos(sr), y)
    output_i, _, output_th = L.gated_stats_from_hops(
        _hop_energies(yko, hop), hop, nv)
    return y, output_i, output_th


# ---------------------------------------------------------------------------
# Sequence-parallel alimiter (exact cross-shard piece carries)
# ---------------------------------------------------------------------------

def _piece_envelope(deps: list, pieces, reverse: bool) -> list:
    """min over the tangent pieces of each piece's (max, x) scan of
    a_p·dep across the shards, each with its exact cross-shard carry
    (``sp_master._scan_carry``): release pieces left to right, attack
    pieces (``reverse``) right to left, on the flipped shards in reverse
    order. Returns the envelope a shard."""
    us = [torch.flip(d, [0]) for d in deps[::-1]] if reverse else deps
    env = None
    for a, rho in pieces:
        s = _scan_carry([W.release_scan(u * a, rho) for u in us], rho)
        env = s if env is None else [torch.minimum(e, x)
                                     for e, x in zip(env, s)]
    return [torch.flip(e, [0]) for e in env[::-1]] if reverse else env


def _alimiter_sp(parts: list, sample_rate: float, limit: float = None,
                 attack_ms: float = None, release_ms: float = None) -> list:
    """``ops.limiter.alimiter_compat`` on sharded audio, exact: one shard
    runs it as is (K1 in both directions on the card); more shards run
    each direction's tangent-piece scans with their cross-shard carries
    (``_piece_envelope``). The depth, the gain and the auto-level scale
    are memoryless."""
    sr = float(sample_rate)
    limit = C.LIMITER_CEILING if limit is None else limit
    attack_ms = C.LIMITER_ATTACK_MS if attack_ms is None else attack_ms
    release_ms = C.LIMITER_RELEASE_MS if release_ms is None else release_ms
    if len(parts) == 1:
        return [alimiter_compat(parts[0], sr, limit, attack_ms, release_ms)]
    A = max(int(round(attack_ms * sr / 1000.0)), 1)
    R = max(release_ms * sr / 1000.0, 1.0)
    scale = float(np.float32(1.0) / np.float32(limit))  # auto-level
    deps = []
    for x in parts:
        peak = torch.amax(x.abs(), dim=1)
        deps.append(torch.clamp(1.0 - peak.new_tensor(limit)
                                / torch.clamp(peak, min=1e-9), min=0.0))
    d_rel = _piece_envelope(deps, _wedge_pieces(R), False)
    d_att = _piece_envelope(deps, _wedge_pieces(float(A)), True)
    return [x * ((1.0 - torch.maximum(r, a)) * scale)[:, None]
            for x, r, a in zip(parts, d_rel, d_att)]


# ---------------------------------------------------------------------------
# The full compat chain
# ---------------------------------------------------------------------------

def master_compat_sequence_parallel(x, sample_rate: float, settings,
                                    mesh: Mesh, axis: str = "sp",
                                    n_valid=None):
    """Master ONE [N, 2] track with reference-compat semantics, the time
    axis sharded over ``mesh``'s ``axis``. Called by
    ``sp_master.master_sequence_parallel`` when ``mode == "compat"``.

    Requirements beyond the quality path: with ``compat_chunked`` each
    shard owns whole 30 s chunks (``local_n % chunk_len == 0``); with
    loudnorm on, ``n_valid`` is a host int and the track is >= 3.1 s (the
    controller's priming window); unchunked multiband needs shards at
    least the pydub detector window long; ``mb_edges`` is refused. Returns
    (y gathered on the axis's first device, info)."""
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    (mode, chunked, multiband_on, analog_on, width_on, lufs_on,
     mb_edges) = settings.structure_key()
    if mode != "compat":
        raise ValueError(f"compat sequence-parallel mastering got mode "
                         f"{mode!r}")
    if mb_edges is not None:
        raise ValueError("mb_edges (G-band multiband) is quality-mode "
                         "only; compat mode is pinned to the reference's "
                         "3-band stage")
    sr = float(sample_rate)
    ndev = mesh.shape[axis]
    n = x.shape[0]
    if n % ndev:
        raise ValueError(f"N={n} not divisible by {ndev} shards")
    local_n = n // ndev
    hop = int(round(0.100 * sr))
    nv = _check_n_valid(n_valid, n)
    if lufs_on:
        if local_n % hop:
            raise ValueError(
                f"shard length {local_n} must be a multiple of the 100 ms "
                f"hop ({hop} samples) when lufs is set")
        # the true track length decides, not the padded buffer: a padded
        # 2 s track would otherwise run the frame controller over zeros
        # instead of the one-device chain's short-track branch
        if nv < (LN.RING + 1) * hop:
            raise ValueError("compat loudnorm needs >= 3.1 s of audio "
                             "(the controller's priming window); use the "
                             "single-chip graph for short tracks")
    if (multiband_on and not chunked
            and local_n < int(_PYDUB_ATTACK_MS * sr / 1000.0)):
        raise ValueError(
            f"shards of {local_n} samples are shorter than the pydub "
            f"detector window; use the single-chip graph for tiny tracks")
    chunk_len = int(C.COMPAT_CHUNK_SECONDS * sr)
    if chunked and local_n % chunk_len:
        raise ValueError(
            f"shard length {local_n} must own whole "
            f"{C.COMPAT_CHUNK_SECONDS:g} s chunks ({chunk_len} samples) "
            f"in chunked compat mode (the Q6 resets make the stages "
            f"shard-local); pad to ndev*chunk_len or use "
            f"master_sequence_parallel_padded")
    precision.apply()
    parts = shard_rows(torch.as_tensor(x, dtype=torch.float32), mesh, axis)

    # stage order of ame_tpu's compat programs: pre, then the measure, then
    # one of the silent / linear / dynamic finishes, each into the alimiter
    if chunked:
        parts = _pre_stages_chunked(parts, settings, sr, chunk_len,
                                    analog_on=analog_on, width_on=width_on,
                                    multiband_on=multiband_on)
    else:
        parts = _pre_stages_unchunked(parts, settings, sr,
                                      analog_on=analog_on,
                                      width_on=width_on)
        if multiband_on:
            parts = _multiband_compat_sp(parts, settings, sr)
    if not lufs_on:
        return gather_rows(_alimiter_sp(parts, sr)), {}

    ln_kw = dict(sr=sr, target_i=float(settings.lufs),
                 target_tp=float(settings.target_tp),
                 target_lra=float(settings.target_lra))
    meas = _loudnorm_measure(parts, nv, **ln_kw)
    # ONE host sync: [silent, linear]
    silent_h, lin_h = torch.stack([meas["silent"], meas["lin_ok"]]).tolist()
    lin_h = lin_h and not silent_h
    zero = meas["gain_db"].new_zeros(())
    if silent_h:
        y = parts                            # quirk Q9 passthrough
        output_i, output_th = meas["input_i"], meas["input_thresh"]
    elif lin_h:
        g = 10.0 ** (meas["gain_db"] / 20.0)
        y = [p * g.to(p.device) for p in parts]
        output_i = meas["input_i"] + meas["gain_db"]
        output_th = meas["input_thresh"] + meas["gain_db"]
    else:
        y, output_i, output_th = _loudnorm_dynamic_apply(parts, nv, meas,
                                                         **ln_kw)
    # ffmpeg's pass 2 writes pcm_s16le (graph/chain._stage_normalize)
    y = _alimiter_sp([quantize.int16_roundtrip(p) for p in y], sr)
    info = {"input_i": meas["input_i"], "input_lra": meas["input_lra"],
            "input_tp": meas["input_tp"],
            "input_thresh": meas["input_thresh"],
            "target_offset": meas["target_offset"],
            "linear_mode": meas["lin_ok"].to(torch.float32),
            "gain_db": meas["gain_db"] if lin_h else zero,
            "output_i": output_i, "output_thresh": output_th}
    return gather_rows(y), info
