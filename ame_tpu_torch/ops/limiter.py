"""Peak limiters (PyTorch port of ``ame_tpu/ops/limiter.py``).

Quality mode, ``lookahead_limiter`` (``_limiter_jit``): the reference's final
``alimiter`` contract (ceiling 0.98, 5 ms attack, 50 ms release) from
associative primitives:

  1. instantaneous target  g_t[n] = min(1, ceiling / peak[n])
  2. lookahead             g_a[n] = min over the NEXT attack window
  3. attack ramp           g_r[n] = mean over the PAST attack window
  4. release               1 - g[n] = max(1 - g_r[n], rho * (1 - g[n-1]))

On a CUDA tensor the quality limiter is one hand-written kernel
(``lookahead_limiter_cuda``, ``csrc/lookahead_limiter.cu``: steps 1-4 and
the gain's product in one launch); on a CPU tensor these steps run as plain
PyTorch (``lookahead_limiter_plain``).

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

import ctypes
import functools
import math

import numpy as np
import torch

from ame_tpu_torch.ops import _build
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.ops._branch import hold
from ame_tpu_torch.ops._count import bump
from ame_tpu_torch.ops.wedge_env import wedge_env_cuda, wedge_env_plain


def lookahead_limiter(x: torch.Tensor, sample_rate: float,
                      ceiling: float = 0.98, attack_ms: float = 5.0,
                      release_ms: float = 50.0, return_gain: bool = False):
    """Limit ``x`` [N, C] to +-ceiling. Gain is linked across channels.
    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version."""
    attack_samples = max(int(attack_ms * sample_rate / 1000.0), 1)
    release_decay = math.exp(-1.0 / (release_ms * sample_rate / 1000.0))
    run = lookahead_limiter_cuda if x.is_cuda else lookahead_limiter_plain
    return run(x, attack_samples, release_decay, ceiling, return_gain)


def lookahead_limiter_plain(x: torch.Tensor, attack_samples: int,
                            release_decay: float, ceiling: float = 0.98,
                            return_gain: bool = False):
    """The limiter in plain PyTorch on ``x``'s device, from the attack
    window in samples and the release's per-sample decay."""
    peak = torch.amax(x.abs(), dim=1)
    g_t = torch.clamp(torch.full((), ceiling, dtype=peak.dtype,
                                 device=peak.device)
                      / torch.clamp(peak, min=1e-9), max=1.0)
    g_a = W.sliding_min_ahead(g_t, attack_samples)
    g_r = W.moving_mean_past(g_a, attack_samples)
    gain = 1.0 - W.release_scan(1.0 - g_r, release_decay)
    y = x * gain[:, None]
    return (y, gain) if return_gain else y


# the geometry of csrc/lookahead_limiter.cu (TILE, THREADS, MAX_W, LOOKBACK)
_LIM_TILE = 4096       # frames a block
_LIM_THREADS = 512     # threads a block, each walking _LIM_TILE / 512 frames
_LIM_MAX_W = 4096      # the largest attack window the kernel takes
_LIM_LOOKBACK = 2048   # rows of rho^(TILE·d) for the look-back across tiles


def _limiter_geometry(n: int):
    """(tiles, status words) of the kernel on n frames: tiles of _LIM_TILE
    frames, a status word a tile and one for the tile counter."""
    tiles = -(-n // _LIM_TILE)
    return tiles, tiles + 1


@functools.lru_cache(maxsize=64)
def _limiter_power_table(rho: float) -> np.ndarray:
    """float32 [TILE + 1 + LOOKBACK]: rho^j for j <= TILE (the walks, the
    block's scan, the carry into each frame), then rho^(TILE·d) for
    d < LOOKBACK (the look-back across tiles). Each entry is the float64
    power of the f32 rho the walks multiply by, rounded to f32 once: in
    [0, 1], and 0 where it underflows."""
    r = np.float64(np.float32(rho))
    exps = np.concatenate([np.arange(_LIM_TILE + 1),
                           _LIM_TILE * np.arange(_LIM_LOOKBACK)])
    return (r ** exps.astype(np.float64)).astype(np.float32)


def _lookback_fits(sms: int, threads_per_sm: int) -> bool:
    """Whether the look-back's powers reach past every tile that can be
    unfinished: a tile's predecessors have all started, so at most one a
    resident block is, plus the 32 a warp reads at once."""
    return sms * (threads_per_sm // _LIM_THREADS) + 32 <= _LIM_LOOKBACK


@functools.lru_cache(maxsize=16)
def _device_limiter_powers(rho: float, device: torch.device) -> torch.Tensor:
    """``_limiter_power_table`` on the card, uploaded once per rho."""
    props = torch.cuda.get_device_properties(device)
    if not _lookback_fits(props.multi_processor_count,
                          props.max_threads_per_multi_processor):
        raise ValueError(f"lookahead_limiter_cuda: {props.name} holds more "
                         f"blocks than its look-back table reaches")
    return torch.from_numpy(_limiter_power_table(rho)).to(device)


@functools.lru_cache(maxsize=None)
def _limiter_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("lookahead_limiter")["path"]))
    lib.lookahead_limiter_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_void_p])
    lib.lookahead_limiter_f32.restype = ctypes.c_int
    lib.lookahead_limiter_error.argtypes = [ctypes.c_int]
    lib.lookahead_limiter_error.restype = ctypes.c_char_p
    built = (lib.lookahead_limiter_tile(), lib.lookahead_limiter_max_w(),
             lib.lookahead_limiter_lookback())
    if built != (_LIM_TILE, _LIM_MAX_W, _LIM_LOOKBACK):
        raise RuntimeError(f"lookahead_limiter.cu's geometry {built} is not "
                           f"the wrapper's")
    return lib


def lookahead_limiter_cuda(x: torch.Tensor, attack_samples: int,
                           release_decay: float, ceiling: float = 0.98,
                           return_gain: bool = False):
    """``lookahead_limiter_plain`` as one kernel launch (and a memset of its
    status words) on the card. x: [N, C] float32 CUDA tensor (made
    contiguous); attack_samples <= 4096. Returns y [N, C], and the gain [N]
    with ``return_gain``. ``lookahead_limiter_cuda.launches`` counts the
    calls that launched it; a call recorded into a CUDA graph counts once,
    at capture."""
    if not x.is_cuda:
        raise ValueError("lookahead_limiter_cuda needs a CUDA tensor; CPU "
                         "tensors go through lookahead_limiter_plain")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"lookahead_limiter_cuda needs an [N, C] float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    w = int(attack_samples)
    if not 1 <= w <= _LIM_MAX_W:
        raise ValueError(f"lookahead_limiter_cuda takes attack windows of 1 "
                         f"to {_LIM_MAX_W} samples, got {w}")
    n, c = x.shape
    if n == 0:
        raise ValueError("lookahead_limiter_cuda: empty input")
    x = x.contiguous()
    if c == 2 and x.data_ptr() % 8:
        x = x.clone()          # a view at an odd offset: stereo loads 8 bytes
    rho = float(np.float32(release_decay))
    powers = hold(_device_limiter_powers(rho, x.device))
    lib = _limiter_lib()
    _, words = _limiter_geometry(n)
    y = torch.empty_like(x)
    gain = torch.empty(n, dtype=x.dtype, device=x.device) if return_gain \
        else None
    status = torch.empty(words, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lookahead_limiter_f32(
            x.data_ptr(), y.data_ptr(), 0 if gain is None else gain.data_ptr(),
            status.data_ptr(), powers.data_ptr(), n, c, w,
            float(np.float32(ceiling)), rho, stream)
    if err != 0:
        what = lib.lookahead_limiter_error(err).decode()
        raise RuntimeError(f"lookahead_limiter_f32 launch failed: CUDA error "
                           f"{err} ({what})")
    bump(lookahead_limiter_cuda)
    return (y, gain) if return_gain else y


lookahead_limiter_cuda.launches = 0


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
