"""ffmpeg ``loudnorm`` two-pass semantics, including DYNAMIC mode (PyTorch
port of ``ame_tpu/ops/loudnorm.py``).

Ported: ``_gauss_weights``, ``_hist_centers``, ``_frame_moments``,
``_controller_gains``, ``_valid_frames``, ``apply_frame_gains``,
``_dynamic_jit`` (here ``_dynamic``), ``dynamic_loudnorm``, the fused pass 1
(``_pass1_fused``), ``loudnorm_pass1``, ``loudnorm`` and
``loudnorm_two_pass``. The controller is the reference's black-box-pinned
af_loudnorm spec, in the same parallel form (a cumulative histogram, a
running max of fresh frames — no per-frame loop); see the JAX module's
docstring for the probed rules. Its block and short-term energies are
direct sums of frame energies (``loudness._block_sums``), where the JAX
module differences a float32 running sum.

Each ``lax.cond`` of the reference (the linear-mode verdict, the
silent-input passthrough) is a ``_branch.device_if_else`` pair on a 0-d
tensor: two IF nodes in a captured CUDA graph, where only the branch the
data selects runs, and one host read when run eagerly. Both branches write
one preallocated output. Everything else stays on the input's device, with
no host read and no host-to-device copy (numbers become 0-d tensors by a
fill, tables are cached per device). This module has no kernel; its
K-weighting runs through ``scan_iir.sosfilt``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops._branch import device_if_else, hold
from ame_tpu_torch.ops.loudness import (_block_sums, _power_to_lufs,
                                        gated_stats_from_hops, measure,
                                        true_peak_db)
from ame_tpu_torch.ops.scan_iir import sosfilt

FRAME_S = 0.100          # 100 ms frames
RING = 30                # 3 s delta ring
GAUSS_TAPS = 21          # gaussian smoothing window
GAUSS_SIGMA = 3.5

# ebur128-style histogram of gating blocks: 0.1 LU bins, [-70, +5)
_HIST_LO = -70.0
_HIST_HI = 5.0
_HIST_STEP = 0.1
_NBINS = int(round((_HIST_HI - _HIST_LO) / _HIST_STEP))  # 750


def _gauss_weights() -> np.ndarray:
    x = np.arange(GAUSS_TAPS) - GAUSS_TAPS // 2
    w = np.exp(-(x ** 2) / (2.0 * GAUSS_SIGMA ** 2))
    return (w / w.sum()).astype(np.float32)


def _hist_centers() -> np.ndarray:
    return (_HIST_LO + (np.arange(_NBINS) + 0.5) * _HIST_STEP).astype(
        np.float32)


@functools.lru_cache(maxsize=8)
def _hist_centers_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hist_centers()).to(device)


def _scalar(v, dtype, device) -> torch.Tensor:
    """v as a 0-d tensor on ``device``: a tensor converted there, a number
    filled there (a fill, not a host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _frame_len(sample_rate: float) -> int:
    return int(round(FRAME_S * sample_rate))


# ---------------------------------------------------------------------------
# Dynamic-mode engine
# ---------------------------------------------------------------------------

def _frame_moments(xp: torch.Tensor, xk: torch.Tensor, L: int):
    """Per-frame measurement of [F·L, C] audio given its K-weighted form:
    the interpolation moments M0 = Σ xk², M1 = Σ xk²·(t/L),
    M2 = Σ xk²·(t/L)² and the per-frame sample peak."""
    FL, c = xp.shape
    nf = FL // L
    xk2 = (xk * xk).reshape(nf, L, c)
    t_rel = torch.arange(L, dtype=xp.dtype, device=xp.device) / L
    M0 = torch.sum(xk2, dim=(1, 2))
    M1 = torch.einsum("flc,l->f", xk2, t_rel)
    M2 = torch.einsum("flc,l->f", xk2, t_rel * t_rel)
    peak = torch.amax(xp.abs().reshape(nf, L * c), dim=1)
    return M0, M1, M2, peak


def _controller_gains(M0, M1, M2, peak, L: int, F_eff: int, blk_valid,
                      target_i, target_tp, target_lra,
                      measured_i, measured_thresh, offset):
    """The dynamic controller on the [F] frame axis: per-frame applied
    gains (g0 at each frame's head, g1 at its tail)."""
    dt, dev = M0.dtype, M0.device

    def s(v):
        return _scalar(v, dt, dev)

    target_i, target_tp, target_lra = s(target_i), s(target_tp), s(target_lra)
    measured_i, measured_thresh, offset = (s(measured_i), s(measured_thresh),
                                           s(offset))
    nf = M0.shape[0]
    # short-term input loudness: trailing 3 s (30 hops) per frame
    st_in = torch.cat([M0.new_full((RING - 1,), -1e9),
                       _power_to_lufs(_block_sums(M0, RING) / (RING * L))])
    # input-side gating blocks (400 ms, one per hop): block ending at f
    blk_lufs = torch.cat([M0.new_full((3,), -1e9),
                          _power_to_lufs(_block_sums(M0, 4) / (4 * L))])

    bin_lufs = hold(_hist_centers_on(dev))
    bin_power = 10.0 ** ((bin_lufs + 0.691) / 10.0)
    blk_idx = torch.clamp((blk_lufs - _HIST_LO) / _HIST_STEP, 0.0,
                          float(_NBINS - 1)).to(torch.int64)
    blk_add = ((blk_lufs > -70.0) & blk_valid).to(dt)

    # cumulative histogram -> running gated integrated loudness and running
    # relative threshold for every prefix at once
    onehot = blk_add[:, None] * (
        blk_idx[:, None] == torch.arange(_NBINS, device=dev)[None, :]).to(dt)
    H = torch.cumsum(onehot, dim=0)                                # [F, NB]
    cnt = torch.sum(H, dim=1)
    mean_p = torch.sum(H * bin_power[None], dim=1) / torch.clamp(cnt, min=1.0)
    rel = torch.where(cnt > 0, _power_to_lufs(mean_p) - 10.0, s(-70.0))
    gmask = torch.where(bin_lufs[None] > rel[:, None], H, torch.zeros_like(H))
    gcnt = torch.sum(gmask, dim=1)
    gp = torch.sum(gmask * bin_power[None], dim=1) / torch.clamp(gcnt, min=1.0)
    glob_cum = torch.where((cnt > 0) & (gcnt > 0), _power_to_lufs(gp),
                           s(-1e9))

    # FIRST_FRAME: priming decides the start state
    st0 = st_in[RING - 1]
    above0 = st0 >= measured_thresh
    env0 = torch.where(st0 <= -70.0, s(0.0),
                       torch.where(above0, target_i - st0,
                                   target_i - measured_i))
    delta0 = 10.0 ** ((offset + env0) / 20.0)

    # pre-latch creep trajectory (closed form); delta k = RING + f is
    # written while processing output frame f
    FE = nf + RING
    karr = torch.arange(FE, device=dev)
    k_src = torch.clamp(karr, max=nf - 1)
    st_k = st_in[k_src]
    inner = karr < F_eff
    creep = ((st_k > measured_thresh) & inner & (karr >= RING)).to(dt)
    d_pre = delta0 * 1.0058 ** torch.cumsum(creep, 0)

    w = _gauss_weights()
    ceil_lin = 10.0 ** (target_tp / 20.0)
    farr = torch.arange(nf, device=dev)
    fz = max(F_eff - 29, 0)
    fro = min(max(F_eff - 28, 0), nf)

    def smooth_gains(delta):
        # gain[f] reads deltas[f-2 .. f+18]; EOF flush: frozen from frame
        # F_eff-29 on at the window value of frame F_eff-28
        dpad = torch.cat([delta0.reshape(1).expand(2), delta])
        gext = 0
        for j in range(GAUSS_TAPS):
            gext = gext + float(w[j]) * dpad[j:j + nf + 1]
        gain = gext[torch.where(farr < fz, farr, fro)]
        gain_next = gext[torch.where(farr + 1 < fz, farr + 1, fro)]
        cap = torch.clamp(ceil_lin / torch.clamp(
            peak * torch.maximum(gain, gain_next), min=1e-9), max=1.0)
        return gain * cap, gain_next * cap

    g0_pre, g1_pre = smooth_gains(d_pre)
    dg = g1_pre - g0_pre
    out_pow_pre = g0_pre * g0_pre * M0 + 2 * g0_pre * dg * M1 + dg * dg * M2
    # trailing sums over frames [lo, f], fewer than RING at the start
    lo = torch.clamp(farr - (RING - 1), min=0)
    st_out = _power_to_lufs(
        _block_sums(F.pad(out_pow_pre, (RING - 1, 0)), RING)
        / ((farr + 1 - lo) * L).to(dt))

    # latch: first INNER frame whose output short-term reaches target_i
    can_latch = (st_out >= target_i) & (farr + RING < F_eff)
    any_latch = torch.any(can_latch) | above0
    latch_f = torch.where(above0, torch.full_like(farr[0], -RING),
                          torch.argmax(can_latch.to(torch.int32)))
    latch_k = torch.where(any_latch, latch_f + RING,
                          torch.full_like(latch_f, FE))

    # post-latch env deltas; a frame below the running relative threshold
    # HOLDS the last fresh delta (running max of fresh indices)
    env_g = torch.clamp(st_k - glob_cum[k_src], min=-target_lra / 2.0,
                        max=target_lra / 2.0)
    cand = 10.0 ** ((offset + env_g + target_i - st_k) / 20.0)
    cand = torch.where(st_k <= -70.0, 10.0 ** (offset / 20.0), cand)
    latch_eff = torch.clamp(latch_k, min=RING)
    fresh = ((karr >= latch_eff) & inner
             & ((st_k <= -70.0) | (st_k >= rel[k_src])))
    last_fresh = torch.cummax(torch.where(fresh, karr, -1), dim=0).values
    fallback = d_pre[torch.clamp(latch_eff - 1, min=0).reshape(1)].reshape(())
    post = torch.where(last_fresh >= 0, cand[torch.clamp(last_fresh, min=0)],
                       fallback)
    delta = torch.where(karr < latch_eff, d_pre, post)
    return smooth_gains(delta)


def _valid_frames(nf: int, L: int, n_valid, device):
    """(F_eff, blk_valid): the number of real frames and the per-frame
    histogram mask (blocks past the true track end never count)."""
    if n_valid is None:
        return nf, torch.ones((nf,), dtype=torch.bool, device=device)
    n_valid = int(n_valid)
    return (-(-n_valid // L),
            (torch.arange(nf, device=device) + 1) * L <= n_valid)


def apply_frame_gains(xp: torch.Tensor, g0, g1, L: int) -> torch.Tensor:
    """Apply per-frame linearly interpolated gains to [F·L, C] audio."""
    FL, c = xp.shape
    nf = FL // L
    t_rel = torch.arange(L, dtype=xp.dtype, device=xp.device) / L
    gain_samples = g0[:, None] + (g1 - g0)[:, None] * t_rel[None, :]
    return (xp.reshape(nf, L, c) * gain_samples[:, :, None]).reshape(FL, c)


def _k_moments(x: torch.Tensor, sample_rate: float, n_valid):
    """Pad to whole frames, K-weight (dynamic domain) and take the frame
    moments. Returns (xp, L, F_eff, blk_valid, M0, M1, M2, peak)."""
    n = x.shape[0]
    L = _frame_len(sample_rate)
    nf = -(-n // L)
    xp = F.pad(x, (0, 0, 0, nf * L - n))
    xk, _ = sosfilt(design.k_weighting_dynamic_sos(sample_rate), xp)
    M0, M1, M2, peak = _frame_moments(xp, xk, L)
    F_eff, blk_valid = _valid_frames(nf, L, n_valid, x.device)
    return xp, L, F_eff, blk_valid, M0, M1, M2, peak


def _dynamic(x, sample_rate, target_i, target_tp, target_lra, measured_i,
             measured_thresh, offset, materialize=True, n_valid=None):
    """Frame-adaptive normalization of [N, C] audio. Returns
    (y or None, output_i, output_thresh); the output stats come from the
    same interpolation moments the controller uses."""
    xp, L, F_eff, blk_valid, M0, M1, M2, peak = _k_moments(x, sample_rate,
                                                           n_valid)
    g0, g1 = _controller_gains(M0, M1, M2, peak, L, F_eff, blk_valid,
                               target_i, target_tp, target_lra,
                               measured_i, measured_thresh, offset)
    y = (apply_frame_gains(xp, g0, g1, L)[:x.shape[0]] if materialize
         else None)
    dg = g1 - g0
    out_pow = g0 * g0 * M0 + 2.0 * g0 * dg * M1 + dg * dg * M2
    output_i, _, output_thresh = gated_stats_from_hops(out_pow, L, n_valid)
    return y, output_i, output_thresh


def dynamic_loudnorm(x: torch.Tensor, sample_rate: float,
                     target_i: float = -24.0, target_tp: float = -2.0,
                     target_lra: float = 7.0, measured_i=0.0,
                     measured_thresh=-70.0, offset=0.0, n_valid=None,
                     materialize: bool = True):
    """Frame-adaptive (dynamic-mode) loudness normalization. Returns
    (y, {"output_i", "output_thresh"}). Inputs shorter than 3.1 s get one
    gain capped to the true-peak ceiling (the reference's stand-in)."""
    if x.ndim == 1:
        x = x[:, None]
    if x.shape[0] < (RING + 1) * _frame_len(sample_rate):
        stats = measure(x, sample_rate, n_valid)
        gain_db = torch.minimum(target_i - stats["input_i"],
                                target_tp - stats["input_tp"])
        gain_db = torch.where(torch.isfinite(stats["input_i"]), gain_db,
                              torch.zeros_like(gain_db))
        y = x * 10.0 ** (gain_db / 20.0)
        return y, {"output_i": stats["input_i"] + gain_db,
                   "output_thresh": stats["input_thresh"] + gain_db}
    y, oi, oth = _dynamic(x, float(sample_rate), target_i, target_tp,
                          target_lra, measured_i, measured_thresh, offset,
                          bool(materialize), n_valid)
    return y, {"output_i": oi, "output_thresh": oth}


# ---------------------------------------------------------------------------
# Pass 1: the JSON stats block
# ---------------------------------------------------------------------------

_TAIL_HOPS = 29   # the flush re-measures the last ~2.9 s


def _pass1_fused(x, sample_rate, target_i, target_tp, target_lra,
                 n_valid=None):
    """Input-side stats + the offset-producing dynamic run off one K-filter
    pass; the flush double-count is emulated on the hop grid by
    re-appending the last 29 hop energies. Returns (input_i, input_lra,
    input_thresh, output_i, output_thresh)."""
    xp, L, F_eff, blk_valid, M0, M1, M2, peak = _k_moments(x, sample_rate,
                                                           n_valid)
    nf = M0.shape[0]
    ND = _TAIL_HOPS
    if n_valid is None:
        hops_dup = torch.cat([M0, M0[nf - ND:]])
        nv_dup = None
    else:
        buf = torch.cat([M0, M0.new_zeros((ND,))])
        start = max(F_eff - ND, 0)
        hops_dup = buf.clone()
        hops_dup[F_eff:F_eff + ND] = buf[start:start + ND]
        nv_dup = (F_eff + ND) * L
    input_i, input_lra, input_thresh = gated_stats_from_hops(hops_dup, L,
                                                             nv_dup)
    g0, g1 = _controller_gains(M0, M1, M2, peak, L, F_eff, blk_valid,
                               target_i, target_tp, target_lra,
                               0.0, -70.0, 0.0)
    dg = g1 - g0
    out_pow = g0 * g0 * M0 + 2.0 * g0 * dg * M1 + dg * dg * M2
    output_i, _, output_thresh = gated_stats_from_hops(
        out_pow, L, None if n_valid is None else F_eff * L)
    return input_i, input_lra, input_thresh, output_i, output_thresh


def loudnorm_pass1(x: torch.Tensor, sample_rate: float,
                   target_i: float = -14.0, target_tp: float = -1.5,
                   target_lra: float = 11.0, n_valid=None,
                   full: bool = True) -> dict:
    """The analog of loudnorm ``print_format=json`` (engine:229-237):
    input_i/input_tp/input_lra/input_thresh, output_i/output_thresh
    (+ output_tp/output_lra when ``full``) and
    target_offset = target_i − output_i. The input-side stats measure the
    last ~2.9 s twice, as ffmpeg's dynamic-mode flush does."""
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    sample_rate = float(sample_rate)
    if n >= (RING + 1) * _frame_len(sample_rate):
        ii, lra, th, oi, oth = _pass1_fused(x, sample_rate, target_i,
                                            target_tp, target_lra, n_valid)
        stats = {"input_i": ii, "input_lra": lra, "input_thresh": th,
                 "input_tp": true_peak_db(x),
                 "output_i": oi, "output_thresh": oth,
                 "target_offset": target_i - oi}
        if full:
            y, _ = dynamic_loudnorm(x, sample_rate, target_i, target_tp,
                                    target_lra, n_valid=n_valid)
            out_stats = measure(y, sample_rate, n_valid)
            stats["output_tp"] = out_stats["input_tp"]
            stats["output_lra"] = out_stats["input_lra"]
        return stats

    # short input: sample-grid duplication + the short-path dynamic run
    nd = min(int(round(2.9 * sample_rate)), n)
    if n_valid is None:
        xdup = torch.cat([x, x[n - nd:]])
        stats = measure(xdup, sample_rate, dynamic_domain=True)
    else:
        nv = int(n_valid)
        start = min(max(nv - nd, 0), n - nd)
        xdup = torch.cat([x, x.new_zeros((nd, x.shape[1]))])
        xdup[nv:nv + nd] = x[start:start + nd]
        stats = measure(xdup, sample_rate, nv + nd, dynamic_domain=True)
    # the concat seam rings in the 4x interpolator: read the true peak off
    # the original signal
    stats["input_tp"] = true_peak_db(x)
    y, out = dynamic_loudnorm(x, sample_rate, target_i, target_tp,
                              target_lra, n_valid=n_valid,
                              materialize=bool(full))
    stats["output_i"] = out["output_i"]
    stats["output_thresh"] = out["output_thresh"]
    stats["target_offset"] = target_i - out["output_i"]
    if full:
        out_stats = measure(y, sample_rate, n_valid)
        stats["output_tp"] = out_stats["input_tp"]
        stats["output_lra"] = out_stats["input_lra"]
    return stats


# ---------------------------------------------------------------------------
# Pass 2 and the two-pass flow
# ---------------------------------------------------------------------------

def loudnorm(x: torch.Tensor, sample_rate: float, target_i: float = -24.0,
             target_tp: float = -2.0, target_lra: float = 7.0,
             measured: dict | None = None, offset=0.0, linear: bool = True,
             n_valid=None):
    """One loudnorm invocation. With ``measured`` pass-1 stats and
    ``linear=True`` it applies the single gain ``target_i − measured_i``
    when every eligibility gate holds (values supplied, the gain keeps the
    true peak legal, measured LRA <= target); otherwise the dynamic
    engine runs, shifted by ``offset``. Returns (y, info) with
    ``linear_mode`` 1.0/0.0 and ``gain_db`` (0.0 when dynamic ran)."""
    if x.ndim == 1:
        x = x[:, None]
    if measured is None:
        zero = x.new_zeros(())
        y, out = dynamic_loudnorm(x, sample_rate, target_i, target_tp,
                                  target_lra)
        return y, {"linear_mode": zero, "gain_db": zero, **out}
    y = torch.empty_like(x)
    return y, _pass2(x, y, sample_rate, target_i, target_tp, target_lra,
                     measured, offset, linear, n_valid)


def _pass2(x, y, sample_rate, target_i, target_tp, target_lra, measured,
           offset, linear, n_valid) -> dict:
    """``loudnorm`` with ``measured`` stats, its output written into y:
    the linear gain or the dynamic engine, chosen on the device."""
    def s(v):
        return _scalar(v, x.dtype, x.device)

    zero = x.new_zeros(())
    m_i, m_tp = s(measured["input_i"]), s(measured["input_tp"])
    m_lra, m_th = s(measured["input_lra"]), s(measured["input_thresh"])
    # ffmpeg ignores ``offset`` in linear mode (gain = target_i − measured_i
    # exactly); in dynamic mode it shifts the whole trajectory
    gain_db = target_i - m_i
    supplied = ((m_tp != 99.0) & (m_th != -70.0) & (m_lra != 0.0)
                & (m_i != 0.0))
    lin_ok = (supplied & (m_tp + gain_db <= target_tp)
              & (m_lra <= target_lra)) if linear else torch.zeros(
                  (), dtype=torch.bool, device=x.device)
    out_i, out_th = x.new_empty(()), x.new_empty(())

    def linear_gain():
        torch.mul(x, 10.0 ** (gain_db / 20.0), out=y)
        out_i.copy_(m_i + gain_db)
        out_th.copy_(m_th + gain_db)

    def dynamic():
        yd, out = dynamic_loudnorm(x, sample_rate, target_i, target_tp,
                                   target_lra, m_i, m_th, offset=offset,
                                   n_valid=n_valid)
        y.copy_(yd)
        out_i.copy_(out["output_i"])
        out_th.copy_(out["output_thresh"])

    device_if_else(lin_ok, linear_gain, dynamic)
    return {"linear_mode": lin_ok.to(x.dtype),
            "gain_db": torch.where(lin_ok, gain_db, zero),
            "output_i": out_i, "output_thresh": out_th}


def loudnorm_two_pass(x: torch.Tensor, sample_rate: float,
                      target_i: float = -14.0, target_tp: float = -1.5,
                      target_lra: float = 11.0, n_valid=None):
    """normalize_loudness_on_disk_with_ffmpeg (engine:227-246): pass 1
    measures and derives ``target_offset`` from the dynamic run; silent
    input (input_i = −inf) passes through unchanged (quirk Q9); pass 2 runs
    with the measured values and the offset."""
    if x.ndim == 1:
        x = x[:, None]
    stats = loudnorm_pass1(x, sample_rate, target_i, target_tp, target_lra,
                           n_valid=n_valid, full=False)
    y = torch.empty_like(x)
    info = {k: x.new_empty(()) for k in ("linear_mode", "gain_db",
                                         "output_i", "output_thresh")}

    def pass2():
        for k, v in _pass2(x, y, sample_rate, target_i, target_tp,
                           target_lra, stats, stats["target_offset"], True,
                           n_valid).items():
            info[k].copy_(v)

    def passthrough():
        y.copy_(x)
        info["linear_mode"].zero_()
        info["gain_db"].zero_()
        info["output_i"].copy_(stats["input_i"])
        info["output_thresh"].copy_(stats["input_thresh"])

    device_if_else(torch.isfinite(stats["input_i"]), pass2, passthrough)
    return y, {**stats, **info}
