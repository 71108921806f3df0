"""Mid/side stereo width (PyTorch port of ``ame_tpu/ops/stereo.py``:
``stereo_width`` for compat mode, ``stereo_width_quality``)."""

from __future__ import annotations

import torch


def stereo_width(x: torch.Tensor, width: float) -> torch.Tensor:
    """x: [N, 2]. mid = (L+R)/2, side = (L-R)/2 * width, re-matrixed with
    the reference's clip to [-1, 1] (engine:270). Mono/ndim != 2 inputs
    pass through untouched."""
    if x.ndim != 2 or x.shape[-1] != 2:
        return x
    left, right = x[:, 0], x[:, 1]
    mid = (left + right) * 0.5
    side = (left - right) * 0.5 * width
    return torch.clamp(torch.stack([mid + side, mid - side], dim=1),
                       -1.0, 1.0)


def stereo_width_quality(x: torch.Tensor, width) -> torch.Tensor:
    """x: [N, 2]. mid = (L+R)/2, side = (L-R)/2 * width, re-matrixed WITHOUT
    the reference's clip (engine:270): headroom is kept for the loudness
    and limiter stages. Mono/ndim != 2 inputs pass through untouched.
    width: a float or a 0-d tensor (differentiable)."""
    if x.ndim != 2 or x.shape[-1] != 2:
        return x
    left, right = x[:, 0], x[:, 1]
    mid = (left + right) * 0.5
    side = (left - right) * 0.5 * width
    return torch.stack([mid + side, mid - side], dim=1)
