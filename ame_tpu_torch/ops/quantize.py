"""int16 round-trip ops (PyTorch port of ``ame_tpu/ops/quantize.py``:
``float_to_int16``, ``int16_to_float``, ``int16_roundtrip`` and
``saturating_add_int16``).

Every stage boundary of the reference re-quantizes to int16 (quirk Q5):
float -> int16 is trunc(clip(x, -1, 1) * 32767) (engine:255-256), int16 ->
float is i / 32768 (engine:253). The saturating add is pydub ``overlay``'s
audioop.add (engine:309, quirk Q7). The JAX module's ``_flatwise`` lane
reshape is a TPU layout trick and has no counterpart here.
"""

from __future__ import annotations

import torch


def float_to_int16(x: torch.Tensor) -> torch.Tensor:
    """trunc(clip(x, -1, 1) * 32767) as float32-held integer values — the
    reference's quantization (engine:255-256), run on x's device."""
    return torch.trunc(torch.clamp(x, -1.0, 1.0) * 32767.0)


def int16_to_float(i: torch.Tensor) -> torch.Tensor:
    return i * (1.0 / 32768.0)


def int16_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """The exact quantization the reference injects between stages."""
    return int16_to_float(float_to_int16(x))


def saturating_add_int16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """audioop.add on int16-valued floats: the sum clamped to
    [-32768, 32767]."""
    return torch.clamp(a + b, -32768.0, 32767.0)
