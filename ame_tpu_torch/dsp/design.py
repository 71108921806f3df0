"""Host-side IIR coefficient design (numpy float64).

Port of ``ame_tpu/dsp/design.py``: ``butter_ba``, ``butter_sos``,
``reference_peak_band_sos``, ``linkwitz_riley_sos``, ``lr4_allpass_sos``,
``k_weighting_sos``, ``_shelf_biquad``,
``k_weighting_dynamic_sos``, ``rbj_low_shelf``, ``rbj_high_shelf``,
``rbj_peaking`` and their helpers ``_rbj_common`` and ``ba_to_sos_biquad``.
A jax-free copy, since importing ``ame_tpu`` imports jax.

All functions return float64 numpy arrays (SOS in scipy layout [k, 6]:
b0, b1, b2, 1, a1, a2); the filtering code casts its tables to f32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy.signal import butter as _scipy_butter


# ---------------------------------------------------------------------------
# Butterworth (compat mode: the reference's scipy.signal.butter designs)
# ---------------------------------------------------------------------------

def butter_ba(order: int, cutoff_norm, btype: str):
    """Butterworth (b, a), cutoff normalized to Nyquist — the reference's
    ``butter(2, cutoff_hz/(0.5*sr), btype)`` calls."""
    b, a = _scipy_butter(order, cutoff_norm, btype=btype)
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


def butter_sos(order: int, cutoff, btype: str,
               fs: float | None = None) -> np.ndarray:
    """Butterworth second-order sections, shape [n_sections, 6]."""
    sos = _scipy_butter(order, cutoff, btype=btype, fs=fs, output="sos")
    return np.asarray(sos, np.float64)


def reference_peak_band_sos(sample_rate: float, center_hz: float,
                            q: float = 1.41) -> np.ndarray:
    """The order-4 bandpass of the reference peak filter with its band-edge
    computation and clamps (audio_mastering_engine.py:292-296, quirk Q14):
    [4, 6]. Where the upper edge clamps to 0.999999 of Nyquist the top
    pole pair sits within ~1e-6 of z = -1."""
    nyquist = 0.5 * sample_rate
    center_norm = center_hz / nyquist
    bandwidth = center_norm / q
    low = center_norm - bandwidth / 2
    high = center_norm + bandwidth / 2
    if low <= 0:
        low = 1e-9
    if high >= 1.0:
        high = 0.999999
    return butter_sos(4, [low, high], "bandpass")


def linkwitz_riley_sos(order: int, cutoff_hz: float, btype: str,
                       fs: float) -> np.ndarray:
    """LR(2n) = squared Butterworth(n): flat-sum crossover. ``order`` is the
    LR order (must be even)."""
    if order % 2:
        raise ValueError("Linkwitz-Riley order must be even")
    half = butter_sos(order // 2, cutoff_hz, btype, fs=fs)
    return np.concatenate([half, half], axis=0)


def lr4_allpass_sos(cutoff_hz: float, fs: float) -> np.ndarray:
    """The 2nd-order allpass A(z) with LP_LR4(z) + HP_LR4(z) == A(z): its
    numerator is the reversed Butterworth-2 denominator. Phase-compensates
    the lower bands of a multi-way LR4 crossover tree so the recombined sum
    stays magnitude-flat (graph/multiband._band_cascades_n)."""
    _, a = butter_ba(2, cutoff_hz / (0.5 * fs), "lowpass")
    return ba_to_sos_biquad(a[::-1], a)


def ba_to_sos_biquad(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """An order-2 (b,a) pair as a single [1, 6] SOS row (a normalized)."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    if len(b) != 3 or len(a) != 3:
        raise ValueError(f"expected biquad (len-3) ba, got {len(b)}/{len(a)}")
    b = b / a[0]
    a = a / a[0]
    return np.concatenate([b, a])[None, :]


# ---------------------------------------------------------------------------
# RBJ cookbook biquads (quality mode)
# ---------------------------------------------------------------------------

def _rbj_common(f0: float, fs: float, q: float):
    w0 = 2.0 * math.pi * f0 / fs
    return w0, math.cos(w0), math.sin(w0) / (2.0 * q)


def rbj_high_shelf(f0: float, fs: float, gain_db: float, q: float) -> np.ndarray:
    A = 10.0 ** (gain_db / 40.0)
    _, cw, alpha = _rbj_common(f0, fs, q)
    sa = 2.0 * math.sqrt(A) * alpha
    b = np.array([
        A * ((A + 1) + (A - 1) * cw + sa),
        -2 * A * ((A - 1) + (A + 1) * cw),
        A * ((A + 1) + (A - 1) * cw - sa),
    ])
    a = np.array([
        (A + 1) - (A - 1) * cw + sa,
        2 * ((A - 1) - (A + 1) * cw),
        (A + 1) - (A - 1) * cw - sa,
    ])
    return ba_to_sos_biquad(b, a)


def rbj_low_shelf(f0: float, fs: float, gain_db: float, q: float) -> np.ndarray:
    A = 10.0 ** (gain_db / 40.0)
    _, cw, alpha = _rbj_common(f0, fs, q)
    sa = 2.0 * math.sqrt(A) * alpha
    b = np.array([
        A * ((A + 1) - (A - 1) * cw + sa),
        2 * A * ((A - 1) - (A + 1) * cw),
        A * ((A + 1) - (A - 1) * cw - sa),
    ])
    a = np.array([
        (A + 1) + (A - 1) * cw + sa,
        -2 * ((A - 1) + (A + 1) * cw),
        (A + 1) + (A - 1) * cw - sa,
    ])
    return ba_to_sos_biquad(b, a)


def rbj_peaking(f0: float, fs: float, gain_db: float, q: float) -> np.ndarray:
    A = 10.0 ** (gain_db / 40.0)
    _, cw, alpha = _rbj_common(f0, fs, q)
    b = np.array([1 + alpha * A, -2 * cw, 1 - alpha * A])
    a = np.array([1 + alpha / A, -2 * cw, 1 - alpha / A])
    return ba_to_sos_biquad(b, a)


# ---------------------------------------------------------------------------
# BS.1770 K-weighting
# ---------------------------------------------------------------------------

# ITU-R BS.1770 pre-filter, exact parametric form: this K = tan(pi*f0/fs)
# shelf/highpass construction reproduces the spec's 48 kHz table to ~1e-14
# and generalizes the filter to any sample rate.
_KW_SHELF_F0 = 1681.974450955533
_KW_SHELF_GAIN_DB = 3.999843853973347
_KW_SHELF_Q = 0.7071752369554196
_KW_VB_EXP = 0.4996667741545416
_KW_HP_F0 = 38.13547087602444
_KW_HP_Q = 0.5003270373238773


def k_weighting_sos(fs: float) -> np.ndarray:
    """K-weighting as a 2-section SOS cascade: stage-1 high shelf (+4 dB above
    ~1.5 kHz, head model) then stage-2 highpass (~38 Hz RLB). The RLB
    numerator is the spec's unnormalized [1, -2, 1]: the cascade has the
    standard ~+0.691 dB gain at 997 Hz that the LUFS formula offsets."""
    # stage 1: high shelf
    K = math.tan(math.pi * _KW_SHELF_F0 / fs)
    Vh = 10.0 ** (_KW_SHELF_GAIN_DB / 20.0)
    Vb = Vh ** _KW_VB_EXP
    Q = _KW_SHELF_Q
    a0 = 1.0 + K / Q + K * K
    shelf = np.array([[
        (Vh + Vb * K / Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / Q + K * K) / a0,
        1.0,
        2.0 * (K * K - 1.0) / a0,
        (1.0 - K / Q + K * K) / a0,
    ]])
    # stage 2: RLB highpass
    K = math.tan(math.pi * _KW_HP_F0 / fs)
    Q = _KW_HP_Q
    a0 = 1.0 + K / Q + K * K
    hp = np.array([[
        1.0, -2.0, 1.0,
        1.0,
        2.0 * (K * K - 1.0) / a0,
        (1.0 - K / Q + K * K) / a0,
    ]])
    return np.concatenate([shelf, hp], axis=0)


def _shelf_biquad(fs: float, f0: float, gain_db: float, q: float,
                  vb_exp: float = 0.5) -> np.ndarray:
    """Stage-1-style parametric high shelf as one [1, 6] SOS row."""
    K = math.tan(math.pi * f0 / fs)
    Vh = 10.0 ** (gain_db / 20.0)
    Vb = Vh ** vb_exp
    a0 = 1.0 + K / q + K * K
    return np.array([[
        (Vh + Vb * K / q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / q + K * K) / a0,
        1.0,
        2.0 * (K * K - 1.0) / a0,
        (1.0 - K / q + K * K) / a0,
    ]])


@functools.lru_cache(maxsize=16)
def _k_weighting_dynamic(fs: float) -> np.ndarray:
    base = k_weighting_sos(fs)
    if fs >= 191999.0:
        return base
    from scipy.optimize import least_squares
    from scipy.signal import sosfreqz
    f = np.linspace(20.0, 0.49 * fs, 1024)
    _, h_n = sosfreqz(base, worN=f, fs=fs)
    _, h_t = sosfreqz(k_weighting_sos(192000.0), worN=f, fs=192000.0)
    t_db = 20.0 * np.log10(np.maximum(np.abs(h_t), 1e-12)
                           / np.maximum(np.abs(h_n), 1e-12))

    def resid(p):
        g, lf0, lq = p
        _, h_c = sosfreqz(_shelf_biquad(fs, math.exp(lf0), g, math.exp(lq)),
                          worN=f, fs=fs)
        return 20.0 * np.log10(np.maximum(np.abs(h_c), 1e-12)) - t_db

    sol = least_squares(resid, x0=[float(t_db[-1]), math.log(_KW_SHELF_F0),
                                   math.log(0.7)], method="lm")
    corr = _shelf_biquad(fs, math.exp(sol.x[1]), sol.x[0],
                         math.exp(sol.x[2]))
    return np.concatenate([base, corr], axis=0)


def k_weighting_dynamic_sos(fs: float) -> np.ndarray:
    """K-weighting as ffmpeg's dynamic-mode loudnorm measures it: its meter
    runs on the 192 kHz upsampled stream, so this is the native-rate
    cascade plus one correction shelf fit (least squares, 1024 points up to
    0.49 fs) to the 192 kHz design's magnitude. [3, 6] below 192 kHz."""
    return _k_weighting_dynamic(float(fs)).copy()
