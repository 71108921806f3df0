"""Quality-mode 4-band EQ (PyTorch port).

Port of the quality half of ``ame_tpu/ops/eq.py``: ``apply_eq_quality``, with
the closed forms of ``_rbj_shelf_coeffs_jnp`` / ``_rbj_peaking_coeffs_jnp``.
Gains are host floats here, so the coefficients come from the same RBJ
formulas in float64 on the host (``dsp/design.rbj_*``). The compat blends
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch import config as C
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops.scan_iir import sosfilt


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


def apply_eq_quality(x: torch.Tensor, sample_rate: float, bass_db: float,
                     mid_cut_db: float, presence_db: float, treble_db: float,
                     peak_q: float = C.PEAK_Q) -> torch.Tensor:
    """Product-grade 4-band EQ over [N, C] audio, run as ONE k=4 cascade."""
    sos = eq_quality_sos(sample_rate, bass_db, mid_cut_db, presence_db,
                         treble_db, peak_q)
    y, _ = sosfilt(sos, x)
    return y
