"""Reference of the ``quality_flagship`` configuration: the quality chain
of ``reference/quality.py`` at its settings, with its loudness stage on
(BS.1770 integrated loudness in float64 and one gain to -14 LUFS), and
the stage's other measurements of the same signal, in float64, into
``info``:

  * ``input_tp``: the 4x true peak in dBTP, from a polyphase bank of 4
    phases x 32 taps (a Kaiser-windowed sinc, beta 5, cut at the input's
    Nyquist, a gain of 4 over its 128 taps, phase 0 a pure delay), each
    phase a causal FIR from zero history, the sample peak included;
  * ``input_lra``: the loudness range (EBU Tech 3342) in LU, from 3 s
    K-weighted blocks at a 1 s hop, a -70 LUFS absolute and a -20 LU
    relative gate, P95 - P10 at the round-nearest order statistics.

The true-peak target does not cap the gain (the reference engine's clean
gain), so neither reading moves the master. ``INFO_LIMITS`` are the
widest gaps between the program's info and these readings that a sound
program shows (PERF.md gives the readings they were set from); the
check of a run compares masters only (``LIMITS``)."""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import sosfilt

from cudabench.reference import quality

# The check's limit on the widest gap, in LSB, between a master the program
# wrote and the reference's (PERF.md gives the readings it was set from).
LIMITS = {"max_lsb": 6}
# Limits on the program's measurements against this reference's: dB of
# true peak (the program's product runs on bf16-rounded samples and
# taps), LU of loudness range.
INFO_LIMITS = {"input_tp": 0.06, "input_lra": 1e-5}

TP_FACTOR = 4
TP_TAPS = 32


def tp_bank() -> np.ndarray:
    """[phase, tap] polyphase interpolation bank of the 4x true peak."""
    taps = TP_FACTOR * TP_TAPS
    k = np.arange(taps) - taps // 2
    h = np.sinc(k / TP_FACTOR) * np.kaiser(taps + 1, 5.0)[:taps]
    h = h / h.sum() * TP_FACTOR
    return h.reshape(TP_TAPS, TP_FACTOR).T


def true_peak_db(x: np.ndarray) -> float:
    """4x true peak of [N, C] samples, dBTP. An interpolant at sample n
    (phase p: the sum over taps t of bank[p, t] * x[n - t]) is at most
    ``reach``, the largest phase's sum of |taps|, times the largest |x| of
    its 32 inputs; it is computed only where that bound passes the sample
    peak, the only places where the true peak can lie above it."""
    bank = tp_bank()
    n, c = x.shape
    level = np.abs(x).max(axis=1)
    peak = level.max(initial=0.0)
    reach = np.abs(bank).sum(axis=1).max()
    hot = np.flatnonzero(level * reach > peak)
    at = np.unique((hot[:, None] + np.arange(TP_TAPS)).ravel())
    at = at[at < n]
    xp = np.concatenate([np.zeros((TP_TAPS - 1, c)), x])  # zero history
    back = TP_TAPS - 1 - np.arange(TP_TAPS)               # x[n - t]
    for i in range(0, at.size, 1 << 16):
        win = xp[at[i:i + (1 << 16), None] + back]        # [k, tap, C]
        y = np.einsum("pt,ktc->kpc", bank, win)
        peak = max(peak, np.abs(y).max(initial=0.0))
    return 20.0 * math.log10(max(peak, 1e-12))


def _lufs(p):
    return -0.691 + 10.0 * np.log10(np.maximum(p, 1e-30))


def loudness_range(x: np.ndarray, fs: float) -> float:
    """EBU Tech 3342 loudness range of [N, C] samples, LU (0 where no
    block passes the gates)."""
    y = sosfilt(quality.k_weighting_sos(fs), x, axis=0)
    hop = int(round(fs))
    n_hops = y.shape[0] // hop
    if n_hops < 3:
        return 0.0
    hops = (y[:n_hops * hop] ** 2).sum(axis=1).reshape(n_hops, hop).sum(1)
    power = np.convolve(hops, np.ones(3), mode="valid") / (3 * hop)
    loud = _lufs(power)
    gate = loud > -70.0
    if not gate.any():
        return 0.0
    gate &= loud > _lufs(power[gate].mean()) - 20.0
    gated = np.sort(loud[gate])
    if gated.size == 0:
        return 0.0
    top = gated.size - 1
    return float(gated[int(np.round(0.95 * top))]
                 - gated[int(np.round(0.10 * top))])


def master(pcm: np.ndarray, fs: float, settings: dict,
           mantissa_bits: int | None = None,
           info: dict | None = None) -> np.ndarray:
    """``quality.master`` of ``settings`` (whose ``lufs`` is set), with
    ``input_tp`` and ``input_lra`` of the signal the gain is applied to
    added to ``info``."""
    info = {} if info is None else info
    if settings.get("lufs") is None:
        raise ValueError("this configuration normalizes loudness")

    def r(v):
        return quality.round_mantissa(v, mantissa_bits)

    x = r(pcm.astype(np.float64) / 32768.0)
    percent = float(settings.get("analog_character", 0.0))
    if percent > 0:
        x = r(np.tanh(x * (1.0 + percent / 100.0 * 0.5)))
        x = r(sosfilt(quality.analog_sos(fs, percent), x, axis=0))
    x = r(sosfilt(quality.eq_sos(fs, settings), x, axis=0))
    width = float(settings.get("width", 1.0))
    if width != 1.0:
        mid = (x[:, 0] + x[:, 1]) * 0.5
        side = (x[:, 0] - x[:, 1]) * 0.5 * width
        x = r(np.stack([mid + side, mid - side], axis=1))
    loud = quality.integrated_lufs(x, fs)
    gain_db = settings["lufs"] - loud if math.isfinite(loud) else 0.0
    info.update(input_i=loud, gain_db=gain_db, input_tp=true_peak_db(x),
                input_lra=loudness_range(x, fs))
    x = r(x * 10.0 ** (gain_db / 20.0))
    info["limiter_in_peak"] = float(np.abs(x).max())
    y = r(quality.limiter(x, fs))
    return np.trunc(np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
