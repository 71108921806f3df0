"""Host-side IIR coefficient design (numpy float64).

Port of ``ame_tpu/dsp/design.py``: ``k_weighting_sos``, ``rbj_low_shelf``,
``rbj_high_shelf``, ``rbj_peaking`` and their helpers ``_rbj_common`` and
``ba_to_sos_biquad``. A jax-free copy, since importing ``ame_tpu`` imports jax.

All functions return float64 numpy arrays in scipy SOS layout [k, 6]
(b0, b1, b2, 1, a1, a2); the filtering code casts its tables to f32.
"""

from __future__ import annotations

import math

import numpy as np


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
