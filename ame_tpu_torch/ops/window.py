"""Sliding-window primitives for the limiter (PyTorch port).

Port of ``ame_tpu/ops/window.py``: ``sliding_min_ahead``,
``sliding_max_ahead``, ``_moving_sum_matrix`` / ``_moving_sum_tiles``,
``moving_sum_past``, ``moving_mean_past``, ``windowed_sum_exclusive`` and
``release_scan``. All run along axis 0 on the input's device. The van Herk / Gil-Werman decomposition keeps every partial
reduction bounded by one window (no long-cumsum cancellation in f32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ame_tpu_torch.ops._branch import hold
from ame_tpu_torch.ops._count import bump


def _pad_to_blocks(x: torch.Tensor, w: int, fill: float):
    n = x.shape[0]
    nb = -(-n // w)
    pad = x.new_full((nb * w - n,) + x.shape[1:], fill)
    return torch.cat([x, pad], dim=0).reshape((nb, w) + x.shape[1:]), n


def _bshape(x: torch.Tensor, flat_len: int):
    return (flat_len,) + (1,) * (x.ndim - 1)


def sliding_min_ahead(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[n] = min(x[n .. min(n+w-1, N-1)]) along axis 0 (window clipped at
    the end): suffix-min of n's block combined with the prefix-min ending at
    n+w-1."""
    xb, n = _pad_to_blocks(x, w, float("inf"))
    suf = torch.flip(torch.cummin(torch.flip(xb, [1]), dim=1).values, [1])
    pre = torch.cummin(xb, dim=1).values
    flat_suf = suf.reshape((-1,) + x.shape[1:])
    flat_pre = pre.reshape((-1,) + x.shape[1:])
    flat_len = flat_pre.shape[0]
    nxt = torch.roll(flat_pre, -(w - 1), dims=0)  # nxt[n] = flat_pre[n+w-1]
    idx = torch.arange(flat_len, device=x.device)
    valid = (idx + w - 1) < flat_len              # wrapped rolls: mask them
    nxt = torch.where(valid.reshape(_bshape(x, flat_len)), nxt,
                      torch.full_like(nxt, float("inf")))
    return torch.minimum(flat_suf, nxt)[:n]


def sliding_max_ahead(x: torch.Tensor, w: int) -> torch.Tensor:
    return -sliding_min_ahead(-x, w)


_LB = 128  # tile length for the matmul formulation


@functools.lru_cache(maxsize=64)
def _moving_sum_matrix(w: int, p: int) -> np.ndarray:
    """[LB, (p+1)*LB] 0/1 band: out[t] sums xcat[v] for
    p*LB + t - w + 1 <= v <= p*LB + t (xcat = p lead tiles | current)."""
    t = np.arange(_LB)[:, None]
    v = np.arange((p + 1) * _LB)[None, :]
    hi = p * _LB + t
    return ((v <= hi) & (v >= hi - w + 1)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _moving_sum_band(w: int, p: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_moving_sum_matrix(w, p)).to(device)


def _moving_sum_tiles(x: torch.Tensor, w: int) -> torch.Tensor:
    """Tile-matmul moving sum: the rectangular window is a banded
    [LB, (p+1)*LB] matrix applied to (p lead tiles | current tile) columns.
    Start clipping falls out of the zero lead padding."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, c = x.shape
    Lb = _LB
    p = -(-(w - 1) // Lb)
    nb = -(-n // Lb)
    xp = F.pad(x, (0, 0, p * Lb, nb * Lb - n))
    xt = xp.reshape(nb + p, Lb, c)
    xcat = torch.cat([xt[i:i + nb] for i in range(p + 1)], dim=1)
    y = torch.einsum("tv,bvc->btc", hold(_moving_sum_band(w, p, x.device)),
                     xcat)
    y = y.reshape(nb * Lb, c)[:n]
    return y[:, 0] if squeeze else y


def moving_sum_past(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[n] = sum of x[max(0, n-w+1) .. n] along axis 0 (window clipped at
    the start). Small windows go through the tile-matmul path, larger ones
    through the van Herk block scans."""
    if w <= 8 * _LB:
        return _moving_sum_tiles(x, w)
    xb, n = _pad_to_blocks(x, w, 0.0)
    pre = torch.cumsum(xb, dim=1)
    suf = torch.flip(torch.cumsum(torch.flip(xb, [1]), dim=1), [1])
    flat_pre = pre.reshape((-1,) + x.shape[1:])
    flat_suf = suf.reshape((-1,) + x.shape[1:])
    flat_len = flat_pre.shape[0]
    idx = torch.arange(flat_len, device=x.device)
    prv = torch.roll(flat_suf, w - 1, dims=0)  # prv[n] = flat_suf[n-w+1]
    # no remainder when the window IS n's block (r == w-1) or is
    # start-clipped (n-w+1 < 0)
    use_prv = ((idx % w) != (w - 1)) & (idx >= w - 1)
    prv = torch.where(use_prv.reshape(_bshape(x, flat_len)), prv,
                      torch.zeros_like(prv))
    return (flat_pre + prv)[:n]


def moving_mean_past(x: torch.Tensor, w: int) -> torch.Tensor:
    """Moving average with start-clipped window (divisor = actual count)."""
    s = moving_sum_past(x, w)
    count = torch.clamp(torch.arange(1, x.shape[0] + 1, device=x.device),
                        max=w).to(x.dtype)
    return s / count.reshape((-1,) + (1,) * (x.ndim - 1))


def windowed_sum_exclusive(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[n] = sum of x[n-w .. n-1] (window strictly before n; ZERO while the
    full window does not fit — pydub's detector sees an empty slice and
    rms == 0 for the first ``w`` frames)."""
    s = moving_sum_past(x, w)
    shifted = torch.cat([s.new_zeros((1,) + x.shape[1:]), s[:-1]], dim=0)
    full = torch.arange(x.shape[0], device=x.device) >= w
    return torch.where(full.reshape(_bshape(x, x.shape[0])), shifted,
                       torch.zeros_like(shifted))


def _shift_right_fill(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Shift by k along ``axis``, filling zeros."""
    head = x.narrow(axis, 0, x.shape[axis] - k)
    pad_shape = list(x.shape)
    pad_shape[axis] = k
    return torch.cat([x.new_zeros(pad_shape), head], dim=axis)


def release_scan(u: torch.Tensor, decay: float) -> torch.Tensor:
    """y[n] = max(u[n], decay * y[n-1]) — exponential-release envelope in the
    (multiply, max) semiring (y[-1] = 0; u assumed >= 0).

    Blocked Kogge-Stone with L = 128 blocks; the block-boundary carry
    c[b+1] = max(e[b], decay^L c[b]) is itself a (max, x) Kogge-Stone prefix
    over the [nb, ...] block ends. Decay powers are squared in float32 on
    the host, as the reference squares its f32 decay.

    ``release_scan.launches`` counts the device kernels a call enqueues
    (each fill of a non-empty tensor, concatenation and elementwise op; the
    same count on the CPU, where they run as host ops): 4 a sweep and up
    to 11 more, so 107 at [9 702 000, 3] (7 sweeps in a block, 17 over the
    blocks' ends). The count is a model of the ops below, not a hook on
    the launches: it changes together with them."""
    n = u.shape[0]
    L = min(128, 1 << max(n - 1, 1).bit_length())
    nb = -(-n // L)
    pad = u.new_zeros((nb * L - n,) + u.shape[1:])
    Y = torch.cat([u, pad], dim=0).reshape((nb, L) + u.shape[1:])
    launches = (nb * L > n) + 1               # the pad's fill, the cat

    dl = np.float32(decay)
    shift = 1
    while shift < L:
        Y = torch.maximum(Y, float(dl) * _shift_right_fill(Y, shift, 1))
        launches += 4                 # the shift's fill and cat, mul, max
        dl = dl * dl
        shift *= 2
    dj = dl  # decay^L

    # carry prefix over block ends: F[b] = running max of dL-decayed e
    e = Y[:, -1]
    P = 1 << max(nb - 1, 1).bit_length() if nb > 1 else 1
    F_ = torch.cat([e, e.new_zeros((P - nb,) + e.shape[1:])], dim=0)
    launches += (P > nb) + 1
    s = 1
    while s < P:
        F_ = torch.maximum(F_, float(dj) * _shift_right_fill(F_, s, 0))
        launches += 4
        dj = dj * dj
        s *= 2
    Cpre = torch.cat([e.new_zeros((1,) + e.shape[1:]), F_[:nb - 1]], dim=0)

    k = torch.arange(1, L + 1, dtype=u.dtype, device=u.device)
    log_decay = float(np.log(np.float32(max(decay, 1e-30))))
    powers = torch.exp(k * log_decay)
    corr = (powers.reshape((1, L) + (1,) * (u.ndim - 1))
            * Cpre.reshape((nb, 1) + u.shape[1:]))
    y = torch.maximum(Y, corr)
    # Cpre's fill and cat; arange, mul, exp; the product, the maximum
    bump(release_scan, n=launches + 7)
    return y.reshape((nb * L,) + u.shape[1:])[:n]


release_scan.launches = 0
