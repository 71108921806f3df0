"""4-band EQ (PyTorch port of ``ame_tpu/ops/eq.py``).

Compat half: ``shelf_blend_compat``, ``peak_blend_compat``,
``apply_shelf_compat``, ``apply_peak_compat`` and ``apply_eq_compat`` — the
reference's blend formulas (engine:283-298):

    shelf, gain_db > 0:  y = x + (lp(x) - x) * (g - 1)
    shelf, gain_db < 0:  y = x*g + (lp(x) - x*g) == lp(x)    (quirk Q1)
    peak:                y = x + bp(x) * (g - 1)

with order-2 Butterworth shelf cores and the order-4 reference bandpass
(``design.reference_peak_band_sos``, quirk Q14). Gains are host floats, so a
zero-gain band is skipped on the host, as the reference returns its input
before filtering (engine:284, 291). ``chunk_len`` (chunked compat, quirk
Q6) runs the cores with their state reset every that many samples
(``_run_sos``: ``sosfilt_chunked``).

Quality half: ``apply_eq_quality`` with the RBJ closed forms of
``_rbj_shelf_coeffs_jnp`` / ``_rbj_peaking_coeffs_jnp``, designed in float64
on the host (``dsp/design.rbj_*``) and run as one k=4 cascade. Tensor
gains (a fit's parameters, ``models/automaster.py``) take the same closed
forms in float32 torch ops instead (``_rbj_shelf_coeffs_t``,
``_rbj_peaking_coeffs_t``), so the cascade is differentiable in them.
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch import config as C
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops.scan_iir import sosfilt, sosfilt_chunked


def _gain_minus_one(gain_db: float) -> float:
    """g - 1 with g = 10^(gain_db/20), rounded to float32 as the
    reference's traced f32 scalar math leaves it."""
    g = np.float32(10.0 ** (np.float32(gain_db) / np.float32(20.0)))
    return float(g - np.float32(1.0))


def shelf_blend_compat(x: torch.Tensor, filtered: torch.Tensor,
                       gain_db: float) -> torch.Tensor:
    """The reference shelf blend (engine:287-289), including the Q1
    collapse to the raw filtered signal for negative gains and identity
    at 0."""
    if gain_db > 0:
        return x + (filtered - x) * _gain_minus_one(gain_db)
    if gain_db < 0:
        return filtered
    return x


def peak_blend_compat(x: torch.Tensor, band: torch.Tensor,
                      gain_db: float) -> torch.Tensor:
    """The reference peak blend (engine:297-298): x + band*(g-1)."""
    return x + band * _gain_minus_one(gain_db)


def _run_sos(sos, x: torch.Tensor, chunk_len: int | None) -> torch.Tensor:
    """The cascade over x: continuous state, or reset every ``chunk_len``
    samples (chunked compat, quirk Q6)."""
    if chunk_len is None:
        return sosfilt(sos, x)[0]
    return sosfilt_chunked(sos, x, chunk_len)


def apply_shelf_compat(x: torch.Tensor, sample_rate: float,
                       cutoff_hz: float, gain_db: float, filter_type: str,
                       chunk_len: int | None = None) -> torch.Tensor:
    """Reference apply_shelf_filter (engine:283-289): order-2 Butterworth
    LP/HP core (cutoff clamped below Nyquist) + compat blend; gain 0 is a
    no-op."""
    if gain_db == 0:
        return x
    cutoff_norm = min(cutoff_hz / (0.5 * sample_rate), 0.999999)
    sos = design.ba_to_sos_biquad(*design.butter_ba(2, cutoff_norm,
                                                    filter_type))
    return shelf_blend_compat(x, _run_sos(sos, x, chunk_len), gain_db)


def apply_peak_compat(x: torch.Tensor, sample_rate: float, center_hz: float,
                      gain_db: float, q: float = C.PEAK_Q,
                      chunk_len: int | None = None) -> torch.Tensor:
    """Reference apply_peak_filter (engine:290-298): order-4 bandpass core
    (edge clamps Q14) + additive blend; gain 0 is a no-op."""
    if gain_db == 0:
        return x
    band = _run_sos(design.reference_peak_band_sos(sample_rate, center_hz, q),
                    x, chunk_len)
    return peak_blend_compat(x, band, gain_db)


def apply_eq_compat(x: torch.Tensor, sample_rate: float, bass_db: float,
                    mid_cut_db: float, presence_db: float, treble_db: float,
                    chunk_len: int | None = None) -> torch.Tensor:
    """The reference 4-band chain (engine:277-281): low shelf 250 Hz ->
    peak 1 kHz (mid_cut NEGATED, quirk Q3) -> peak 4 kHz -> high shelf
    8 kHz. Both channels ride one filter call; ``chunk_len`` resets the
    filters' state every that many samples (chunked compat)."""
    x = apply_shelf_compat(x, sample_rate, C.BASS_SHELF_HZ, bass_db, "low",
                           chunk_len)
    x = apply_peak_compat(x, sample_rate, C.MID_PEAK_HZ, -mid_cut_db,
                          C.PEAK_Q, chunk_len)
    x = apply_peak_compat(x, sample_rate, C.PRESENCE_PEAK_HZ, presence_db,
                          C.PEAK_Q, chunk_len)
    return apply_shelf_compat(x, sample_rate, C.TREBLE_SHELF_HZ, treble_db,
                              "high", chunk_len)


def eq_quality_sos(sample_rate: float, bass_db: float, mid_cut_db: float,
                   presence_db: float, treble_db: float,
                   peak_q: float = C.PEAK_Q) -> np.ndarray:
    """[4, 6] cascade: RBJ low shelf 250 Hz, peaking 1 kHz (cut, quirk Q3
    negation), peaking 4 kHz, high shelf 8 kHz."""
    return np.concatenate([
        design.rbj_low_shelf(C.BASS_SHELF_HZ, sample_rate, bass_db, 0.7071),
        design.rbj_peaking(C.MID_PEAK_HZ, sample_rate, -mid_cut_db, peak_q),
        design.rbj_peaking(C.PRESENCE_PEAK_HZ, sample_rate, presence_db,
                           peak_q),
        design.rbj_high_shelf(C.TREBLE_SHELF_HZ, sample_rate, treble_db,
                              0.7071),
    ])


def _rbj_shelf_coeffs_t(f0: float, fs: float, gain_db: torch.Tensor,
                        q: float, kind: str) -> torch.Tensor:
    """RBJ low/high shelf [6] of a tensor gain, closed form in float32
    torch ops (``ame_tpu/ops/eq.py::_rbj_shelf_coeffs_jnp``)."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / fs
    cw = float(np.cos(w0))
    alpha = float(np.sin(w0) / (2.0 * q))
    sa = 2.0 * torch.sqrt(A) * alpha
    if kind == "high":
        b0 = A * ((A + 1) + (A - 1) * cw + sa)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - sa)
        a0 = (A + 1) - (A - 1) * cw + sa
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - sa
    else:
        b0 = A * ((A + 1) - (A - 1) * cw + sa)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - sa)
        a0 = (A + 1) + (A - 1) * cw + sa
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - sa
    return torch.stack([b0 / a0, b1 / a0, b2 / a0, torch.ones_like(a0),
                        a1 / a0, a2 / a0])


def _rbj_peaking_coeffs_t(f0: float, fs: float, gain_db: torch.Tensor,
                          q: float) -> torch.Tensor:
    """RBJ peaking [6] of a tensor gain, closed form in float32 torch ops
    (``ame_tpu/ops/eq.py::_rbj_peaking_coeffs_jnp``)."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / fs
    cw = float(np.cos(w0))
    alpha = float(np.sin(w0) / (2.0 * q))
    b0 = 1 + alpha * A
    b1 = -2 * cw * torch.ones_like(A)
    b2 = 1 - alpha * A
    a0 = 1 + alpha / A
    a2 = 1 - alpha / A
    return torch.stack([b0 / a0, b1 / a0, b2 / a0, torch.ones_like(a0),
                        b1 / a0, a2 / a0])


def eq_quality_sos_t(sample_rate: float, bass_db, mid_cut_db, presence_db,
                     treble_db, peak_q: float = C.PEAK_Q) -> torch.Tensor:
    """``eq_quality_sos`` of tensor gains: one float32 [4, 6] tensor."""
    return torch.stack([
        _rbj_shelf_coeffs_t(C.BASS_SHELF_HZ, sample_rate, bass_db, 0.7071,
                            "low"),
        _rbj_peaking_coeffs_t(C.MID_PEAK_HZ, sample_rate, -mid_cut_db,
                              peak_q),
        _rbj_peaking_coeffs_t(C.PRESENCE_PEAK_HZ, sample_rate, presence_db,
                              peak_q),
        _rbj_shelf_coeffs_t(C.TREBLE_SHELF_HZ, sample_rate, treble_db,
                            0.7071, "high"),
    ]).to(torch.float32)


def apply_eq_quality(x: torch.Tensor, sample_rate: float, bass_db,
                     mid_cut_db, presence_db, treble_db,
                     peak_q: float = C.PEAK_Q) -> torch.Tensor:
    """Product-grade 4-band EQ over [N, C] audio, run as ONE k=4 cascade.
    Float gains: the float64 host design. Any tensor gain: all four as
    float32 tensors through the torch designs (differentiable)."""
    gains = (bass_db, mid_cut_db, presence_db, treble_db)
    if any(isinstance(g, torch.Tensor) for g in gains):
        sos = eq_quality_sos_t(sample_rate, *(
            torch.as_tensor(g, dtype=torch.float32, device=x.device)
            for g in gains), peak_q=peak_q)
    else:
        sos = eq_quality_sos(sample_rate, bass_db, mid_cut_db, presence_db,
                             treble_db, peak_q)
    y, _ = sosfilt(sos, x)
    return y
