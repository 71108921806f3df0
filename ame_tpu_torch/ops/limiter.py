"""Peak limiters (PyTorch port of ``ame_tpu/ops/limiter.py``).

Quality mode, ``lookahead_limiter`` (``_limiter_jit``): the reference's final
``alimiter`` contract (ceiling 0.98, 5 ms attack, 50 ms release) from
associative primitives:

  1. instantaneous target  g_t[n] = min(1, ceiling / peak[n])
  2. lookahead             g_a[n] = min over the NEXT attack window
  3. attack ramp           g_r[n] = mean over the PAST attack window
  4. release               1 - g[n] = max(1 - g_r[n], rho * (1 - g[n-1]))

Compat mode, ``alimiter_compat`` (``_alimiter_jit``, ``_alimiter_depth``,
``_wedge_pieces``): ffmpeg's linear attack/release ramps as the (max, ×)
wedge envelope d[n] = max_k dep[k]·tent(n − k), each wedge side being the
lower envelope of 6 tangent pieces, each piece a constant-decay (max, ×)
scan; output auto-levelled by 1/limit. On a CUDA tensor each direction's
min-over-pieces envelope is one launch of K1's counterpart
(``ops/wedge_env.wedge_env_cuda``); on a CPU tensor, and whenever a stream
carry is given, the 12 plain ``release_scan`` calls run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops.wedge_env import wedge_env_cuda, wedge_env_plain


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


_WEDGE_FRACTIONS = (0.0, 0.3, 0.55, 0.75, 0.88, 0.95)


def _wedge_pieces(width: float):
    """(gain a_j, decay rho_j) tangent pieces of the linear wedge 1 - m/W in
    log space; the min over the piece scans upper-bounds the wedge max-conv
    (the ceiling guarantee survives)."""
    out = []
    for fr in _WEDGE_FRACTIONS:
        mj = fr * width
        rho = math.exp(-1.0 / (width - mj))
        a = (1.0 - fr) * math.exp(mj / (width - mj))
        out.append((a, rho))
    return tuple(out)


def _alimiter_depth(dep: torch.Tensor, pieces_r, pieces_a, rel_carry=None):
    """Depth envelope max(release side, attack side) of [N] depths.

    ``rel_carry``: per-piece [P] release-scan states carried from a previous
    stream block (None = zero history); with it the plain scans run and the
    per-piece forward scans s_fwd [P, N] are returned for the next carry.
    Only the streaming form, not yet ported, passes a carry.
    Returns (d [N], s_fwd or None)."""
    if rel_carry is None:
        env = wedge_env_cuda if dep.is_cuda else wedge_env_plain
        d_rel = env(dep.contiguous(), pieces_r, False)
        d_att = env(dep.contiguous(), pieces_a, True)
        return torch.maximum(d_rel, d_att), None
    fwd = []
    for i, (a, rho) in enumerate(pieces_r):
        # one synthetic leading sample re-seeds the scan exactly
        u = torch.cat([rel_carry[i].reshape(1), dep * a])
        fwd.append(W.release_scan(u, rho)[1:])
    d_rel = torch.stack(fwd).amin(dim=0)
    d_att = wedge_env_plain(dep, pieces_a, True)
    return torch.maximum(d_rel, d_att), torch.stack(fwd)


def alimiter_compat(x: torch.Tensor, sample_rate: float, limit: float = 0.98,
                    attack_ms: float = 5.0, release_ms: float = 50.0,
                    return_gain: bool = False):
    """The reference's final stage with ffmpeg-contract ramps
    (``alimiter=level_in=1:level_out=1:limit=0.98:attack=5:release=50``,
    engine:223): linear attack/release envelope, zero-latency alignment,
    and ffmpeg's default auto-level 1/limit output scale (masters peak at
    ~1.0, not 0.98). Levels in and out are ffmpeg's defaults, 1."""
    A = max(int(round(attack_ms * sample_rate / 1000.0)), 1)
    R = max(release_ms * sample_rate / 1000.0, 1.0)
    peak = torch.amax(x.abs(), dim=1)
    dep = torch.clamp(1.0 - peak.new_tensor(limit)
                      / torch.clamp(peak, min=1e-9), min=0.0)
    d, _ = _alimiter_depth(dep, _wedge_pieces(R), _wedge_pieces(float(A)))
    gain = 1.0 - d
    y = x * (gain * float(np.float32(1.0) / np.float32(limit)))[:, None]
    return (y, gain) if return_gain else y
