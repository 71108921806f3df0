"""Float -> int16 quantization (PyTorch port of
``ame_tpu/ops/quantize.py::float_to_int16``)."""

from __future__ import annotations

import torch


def float_to_int16(x: torch.Tensor) -> torch.Tensor:
    """trunc(clip(x, -1, 1) * 32767) as float32-held integer values — the
    reference's quantization (engine:255-256), run on x's device."""
    return torch.trunc(torch.clamp(x, -1.0, 1.0) * 32767.0)
