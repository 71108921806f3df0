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
(``ops/wedge_env.wedge_env_cuda``); on a CPU tensor the 12 plain
``release_scan`` calls run.

Streaming form, ``alimiter_stream_init`` / ``alimiter_stream_step``
(``_STREAM_HOLD_FACTOR``): the compat limiter continued exactly across
blocks. The release side carries each piece's scan state from block to
block, so it runs on the six per-piece scans (K1 returns only the min over
pieces, not the states); the attack side holds no carry (the stream holds
back ``16·A`` samples instead), so on a CUDA tensor it is K1's reverse
direction, as offline.
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
    g_t = torch.clamp(torch.full((), ceiling, dtype=peak.dtype,
                                 device=peak.device)
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
    stream block (None = zero history); with it the release side runs the
    per-piece scans and returns them, s_fwd [P, N], for the next carry. The
    attack side never carries: it is K1's reverse direction on a CUDA
    tensor either way. Returns (d [N], s_fwd or None)."""
    env = wedge_env_cuda if dep.is_cuda else wedge_env_plain
    dep = dep.contiguous()
    d_att = env(dep, pieces_a, True)
    if rel_carry is None:
        return torch.maximum(env(dep, pieces_r, False), d_att), None
    fwd = []
    for i, (a, rho) in enumerate(pieces_r):
        # one synthetic leading sample re-seeds the scan exactly
        u = torch.cat([rel_carry[i].reshape(1), dep * a])
        fwd.append(W.release_scan(u, rho)[1:])
    s_fwd = torch.stack(fwd)
    return torch.maximum(s_fwd.amin(dim=0), d_att), s_fwd


def alimiter_compat(x: torch.Tensor, sample_rate: float, limit: float = 0.98,
                    attack_ms: float = 5.0, release_ms: float = 50.0,
                    level_in: float = 1.0, level_out: float = 1.0,
                    auto_level: bool = True, return_gain: bool = False):
    """The reference's final stage with ffmpeg-contract ramps
    (``alimiter=level_in=1:level_out=1:limit=0.98:attack=5:release=50``,
    engine:223): linear attack/release envelope, zero-latency alignment,
    and ffmpeg's auto-level output scale ``level_out / limit`` (at the
    defaults masters peak at ~1.0, not 0.98; ``auto_level=False`` scales by
    ``level_out`` alone). The input is scaled by ``level_in`` first and the
    depths come from its peaks. The levels are float32, as in ``ame_tpu``."""
    A = max(int(round(attack_ms * sample_rate / 1000.0)), 1)
    R = max(release_ms * sample_rate / 1000.0, 1.0)
    if level_in != 1.0:
        x = x * float(np.float32(level_in))
    peak = torch.amax(x.abs(), dim=1)
    dep = torch.clamp(1.0 - torch.full((), limit, dtype=peak.dtype,
                                       device=peak.device)
                      / torch.clamp(peak, min=1e-9), min=0.0)
    d, _ = _alimiter_depth(dep, _wedge_pieces(R), _wedge_pieces(float(A)))
    gain = 1.0 - d
    scale = (np.float32(level_out) / np.float32(limit) if auto_level
             else np.float32(level_out))
    y = x * (gain * float(scale))[:, None]
    return (y, gain) if return_gain else y


# ---------------------------------------------------------------------------
# Streaming form (exact continuation across blocks)
# ---------------------------------------------------------------------------
#
# The release side carries forward exactly through the per-piece scan
# states. The attack side needs lookahead: the slowest attack piece decays
# as e^(-m/A), so holding back H = 16*A samples puts any unseen-future
# contribution below f32 resolution (e^-16 ~ 1e-7): the streamed output is
# 1-LSB-identical to the offline form.

_STREAM_HOLD_FACTOR = 16


def alimiter_stream_init(sample_rate: float, limit: float = 0.98,
                         attack_ms: float = 5.0, release_ms: float = 50.0,
                         level_in: float = 1.0, level_out: float = 1.0,
                         auto_level: bool = True, device="cpu") -> dict:
    """The stream's state before its first block: host constants, and the
    held-back samples ``pend`` [0, 2] and the release carries ``carry`` [6]
    as float32 tensors on ``device``."""
    A = max(int(round(attack_ms * sample_rate / 1000.0)), 1)
    R = max(release_ms * sample_rate / 1000.0, 1.0)
    pieces_r = _wedge_pieces(R)
    return {
        "pieces_r": pieces_r, "pieces_a": _wedge_pieces(float(A)),
        "hold": _STREAM_HOLD_FACTOR * A,
        "limit": float(limit), "level_in": float(level_in),
        "scale": (float(level_out) / float(limit) if auto_level
                  else float(level_out)),
        "pend": torch.zeros((0, 2), dtype=torch.float32, device=device),
        "carry": torch.zeros(len(pieces_r), dtype=torch.float32,
                             device=device),
    }


def alimiter_stream_step(x_block: torch.Tensor, state: dict,
                         flush: bool = False):
    """Process one block [n, 2] on the state's device; returns (emitted
    samples, new state). Emission lags by up to ``hold`` samples until
    ``flush``; how many samples a call emits follows from shapes alone."""
    pend = state["pend"]
    xin = torch.cat([pend, x_block.to(pend.device, torch.float32)
                     * state["level_in"]], dim=0)
    n = xin.shape[0]
    emit = n if flush else max(n - state["hold"], 0)
    if n == 0 or emit == 0:
        return xin.new_zeros((0, 2)), {**state, "pend": xin}
    peak = torch.amax(xin.abs(), dim=1)
    dep = torch.clamp(1.0 - peak.new_tensor(state["limit"])
                      / torch.clamp(peak, min=1e-9), min=0.0)
    d, s_fwd = _alimiter_depth(dep, state["pieces_r"], state["pieces_a"],
                               rel_carry=state["carry"])
    gain = 1.0 - d
    y = xin[:emit] * (gain[:emit] * state["scale"])[:, None]
    return y, {**state, "pend": xin[emit:], "carry": s_fwd[:, emit - 1]}
