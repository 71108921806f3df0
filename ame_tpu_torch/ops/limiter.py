"""Lookahead peak limiter, quality mode (PyTorch port of
``ame_tpu/ops/limiter.py::lookahead_limiter`` / ``_limiter_jit``).

Same contract as the reference's final ``alimiter`` stage (ceiling 0.98,
5 ms attack, 50 ms release), built from associative primitives:

  1. instantaneous target  g_t[n] = min(1, ceiling / peak[n])
  2. lookahead             g_a[n] = min over the NEXT attack window
  3. attack ramp           g_r[n] = mean over the PAST attack window
  4. release               1 - g[n] = max(1 - g_r[n], rho * (1 - g[n-1]))

The ffmpeg-contract ``alimiter_compat`` and its wedge-envelope kernel (K1)
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from ame_tpu_torch.ops import window as W


def lookahead_limiter(x: torch.Tensor, sample_rate: float,
                      ceiling: float = 0.98, attack_ms: float = 5.0,
                      release_ms: float = 50.0, return_gain: bool = False):
    """Limit ``x`` [N, C] to +-ceiling. Gain is linked across channels."""
    attack_samples = max(int(attack_ms * sample_rate / 1000.0), 1)
    release_decay = math.exp(-1.0 / (release_ms * sample_rate / 1000.0))
    peak = torch.amax(x.abs(), dim=1)
    g_t = torch.clamp(peak.new_tensor(ceiling)
                      / torch.clamp(peak, min=1e-9), max=1.0)
    g_a = W.sliding_min_ahead(g_t, attack_samples)
    g_r = W.moving_mean_past(g_a, attack_samples)
    gain = 1.0 - W.release_scan(1.0 - g_r, release_decay)
    y = x * gain[:, None]
    return (y, gain) if return_gain else y
