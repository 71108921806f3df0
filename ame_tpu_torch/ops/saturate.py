"""Analog character (PyTorch port of ``ame_tpu/ops/saturate.py``:
``analog_character_compat`` and ``analog_character_quality``).

    drive = 1 + 0.5 * (percent/100)
    y = tanh(x * drive)
    compat:  compat shelf blend 120 Hz low (+percent/100 dB), then 12 kHz
             high (+1.5*percent/100 dB) — two k=1 Butterworth cores
             (their state reset every ``chunk_len`` samples when chunked)
    quality: RBJ low shelf 120 Hz -> RBJ high shelf 12 kHz, one k=2 cascade
             (float64 host designs of a float percent; float32 torch designs,
             differentiable, of a tensor percent)
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch import config as C
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import eq
from ame_tpu_torch.ops.scan_iir import sosfilt


def analog_character_compat(x: torch.Tensor, sample_rate: float,
                            character_percent: float,
                            chunk_len: int | None = None) -> torch.Tensor:
    factor = character_percent / 100.0
    y = torch.tanh(x * (1.0 + factor * 0.5))
    y = eq.apply_shelf_compat(y, sample_rate, C.ANALOG_LOW_SHELF_HZ,
                              factor * 1.0, "low", chunk_len)
    return eq.apply_shelf_compat(y, sample_rate, C.ANALOG_HIGH_SHELF_HZ,
                                 factor * 1.5, "high", chunk_len)


def analog_sos(sample_rate: float, character_percent: float) -> np.ndarray:
    factor = character_percent / 100.0
    return np.concatenate([
        design.rbj_low_shelf(C.ANALOG_LOW_SHELF_HZ, sample_rate,
                             factor * 1.0, 0.7071),
        design.rbj_high_shelf(C.ANALOG_HIGH_SHELF_HZ, sample_rate,
                              factor * 1.5, 0.7071),
    ])


def analog_sos_t(sample_rate: float,
                 character_percent: torch.Tensor) -> torch.Tensor:
    """``analog_sos`` of a tensor percent: one float32 [2, 6] tensor."""
    factor = character_percent / 100.0
    return torch.stack([
        eq._rbj_shelf_coeffs_t(C.ANALOG_LOW_SHELF_HZ, sample_rate,
                               factor * 1.0, 0.7071, "low"),
        eq._rbj_shelf_coeffs_t(C.ANALOG_HIGH_SHELF_HZ, sample_rate,
                               factor * 1.5, 0.7071, "high"),
    ]).to(torch.float32)


def analog_character_quality(x: torch.Tensor, sample_rate: float,
                             character_percent) -> torch.Tensor:
    """character_percent: a float (host design) or a tensor
    (differentiable design)."""
    drive = 1.0 + character_percent / 100.0 * 0.5
    y = torch.tanh(x * drive)
    sos = (analog_sos_t(sample_rate, character_percent)
           if isinstance(character_percent, torch.Tensor)
           else analog_sos(sample_rate, character_percent))
    y, _ = sosfilt(sos, y)
    return y
