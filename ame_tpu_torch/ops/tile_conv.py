"""Tile-convolution cascade filter — the plain PyTorch version of the cascade.

Port of ``ame_tpu/ops/tile_conv.py``: ``_tables_np``, ``_host_pack_cached``,
``_host_partial_cached``, ``_carry_prefix_tiles``, ``_tileconv_run`` and
``_traced_tables`` (the tables of a coefficient tensor). It is
the reference the CUDA kernel (``ops/cascade_scan.py``) is held to: the CPU
path of ``scan_iir.sosfilt`` runs it, and ``chip_smoke.py`` calls it directly
on a CUDA tensor to compare with the kernel. It is never the main path on a
card.

A linear filter restricted to a 128-sample tile is a small matrix product.
For the cascade's state space (A [D,D], B, Crow, d):

    y_tile = H · x_tile + W · c,      c_next = A^L · c + R · x_tile

    h[0] = d,  h[m] = Crow A^(m-1) B     H[t, u] = h[t - u] (u <= t)  [L, L]
    W[t] = Crow A^t                      [L, D]
    R[:, u] = A^(L-1-u) B                [D, L]

The carry c (the state at each tile boundary) is a parallel Kogge-Stone
prefix over [n_tiles, D, C]. Tables are built on the host in float64 and cast
to f32; every product is a true-fp32 ``einsum`` (the chain turns TF32 off,
``ame_tpu_torch/precision.py``), so each output is a direct L-term dot
product with ~1e-7 relative error against float64 scipy. Device copies of
the tables are cached per (coefficients, device).

A [k, 6] coefficient tensor (the quality designs of a tensor gain) builds
the same tables in torch ops of its dtype instead (``_traced_tables``): A
powers by doubling, no cache. That route is differentiable in the
coefficients and in x, on either device; in float64 it is the arbiter the
kernel backward (``scan_iir.SosfiltFn``) is held to.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ame_tpu_torch.ops.scan_iir import (_cascade_state_space, _state_space_np,
                                        _zf_from_state, _zi_to_state,
                                        _zi_transforms)

# Tile length (time samples per tile): H is [LB, LB].
_LB = 128

_CARRY_LEVELS = 40  # A^(L·2^j) tables cover N up to LB * 2^40


# ---------------------------------------------------------------------------
# Host (float64) tables
# ---------------------------------------------------------------------------

def _tables_np(sos_np: np.ndarray, Lb: int):
    """f64 (H, W, R, Apow) from the cascade state space. Apow: [Lb+1, D, D]."""
    A, B, Crow, dpass, Vf, Vi = _state_space_np(np.asarray(sos_np, np.float64))
    D = A.shape[0]
    Apow = np.empty((Lb + 1, D, D))
    Apow[0] = np.eye(D)
    for t in range(1, Lb + 1):
        Apow[t] = Apow[t - 1] @ A
    h = np.empty(Lb)
    h[0] = dpass
    if Lb > 1:
        # h[m] = Crow A^(m-1) B, m >= 1
        h[1:] = np.einsum("j,tjm,m->t", Crow, Apow[: Lb - 1], B)
    idx = np.arange(Lb)
    dif = idx[:, None] - idx[None, :]
    H = np.where(dif >= 0, h[np.clip(dif, 0, Lb - 1)], 0.0)
    W = np.einsum("j,tjm->tm", Crow, Apow[:Lb])          # [Lb, D]
    R = np.einsum("ujm,m->ju", Apow[Lb - 1 :: -1], B)     # [D, Lb]
    return H, W, R, Apow, (A, B, Crow, dpass, Vf, Vi)


def _f32(a) -> np.ndarray:
    return np.nan_to_num(np.asarray(a, np.float32), nan=0.0, posinf=0.0,
                         neginf=0.0)


@functools.lru_cache(maxsize=256)
def _host_pack_cached(sos_bytes: bytes, k: int, Lb: int) -> dict:
    """f32 tables (numpy), plus the f64 A powers and B for partial tables."""
    sos_np = np.frombuffer(sos_bytes, np.float64).reshape(k, 6)
    H, W, R, Apow, (A, B, Crow, dpass, Vf, Vi) = _tables_np(sos_np, Lb)
    with np.errstate(over="ignore", invalid="ignore"):
        carry = []
        M = Apow[Lb].copy()
        for _ in range(_CARRY_LEVELS):
            carry.append(M)
            M = M @ M
            M[~np.isfinite(M)] = 0.0  # decayed past f64: exact zero
    return {
        "H": _f32(H), "W": _f32(W), "R": _f32(R),
        "carry": _f32(np.stack(carry)),
        "Apow": Apow, "B": B,
        "Vf": _f32(Vf), "Vi": _f32(Vi),
    }


@functools.lru_cache(maxsize=512)
def _host_partial_cached(sos_bytes: bytes, k: int, Lb: int, ki: int):
    """Final-state extraction for a track ending at within-tile offset
    ``ki``: zf = A^(ki+1) · c_last + Px · x_last_tile with
    Px[:, u] = A^(ki-u) B for u <= ki."""
    pack = _host_pack_cached(sos_bytes, k, Lb)
    Apow, B = pack["Apow"], pack["B"]
    D = Apow.shape[1]
    Px = np.zeros((D, Lb))
    for u in range(ki + 1):
        Px[:, u] = Apow[ki - u] @ B
    return _f32(Apow[ki + 1]), _f32(Px)


@functools.lru_cache(maxsize=256)
def _device_pack(sos_bytes: bytes, k: int, Lb: int, device: torch.device):
    pack = _host_pack_cached(sos_bytes, k, Lb)
    return tuple(torch.from_numpy(pack[name]).to(device)
                 for name in ("H", "W", "R", "carry", "Vf", "Vi"))


@functools.lru_cache(maxsize=512)
def _device_partial(sos_bytes: bytes, k: int, Lb: int, ki: int,
                    device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in _host_partial_cached(sos_bytes, k, Lb, ki))


# ---------------------------------------------------------------------------
# Carry prefix (Kogge-Stone on [nb, D, C] with per-level matrices)
# ---------------------------------------------------------------------------

def _shift_rows(F_: torch.Tensor, s: int) -> torch.Tensor:
    """Shift by s along axis 0, filling zeros."""
    return torch.cat([F_.new_zeros((s,) + F_.shape[1:]), F_[:-s]], dim=0)


def _carry_prefix_tiles(carry: torch.Tensor, e: torch.Tensor,
                        c0: torch.Tensor) -> torch.Tensor:
    """c[b+1] = AL c[b] + e[b] solved in parallel; e: [nb, D, C],
    c0: [D, C]. Returns [nb, D, C] of states BEFORE each tile."""
    nb = e.shape[0]
    e = torch.cat([(e[0] + carry[0] @ c0)[None], e[1:]], dim=0)
    P = 1 << max(nb - 1, 1).bit_length() if nb > 1 else 1
    F_ = F.pad(e, (0, 0, 0, 0, 0, P - nb))
    s, lvl = 1, 0
    while s < P:
        F_ = F_ + torch.einsum("dm,bmc->bdc", carry[lvl], _shift_rows(F_, s))
        s *= 2
        lvl += 1
    return torch.cat([c0[None], F_[: nb - 1]], dim=0)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _tileconv_run(x, H, W, R, carry, Pc, Px, c0, N: int, Lb: int):
    """x: the zero-padded [nb*Lb, C] buffer plus the true N for the output
    slice. Returns (y [N, C], final internal state [D, C])."""
    C = x.shape[1]
    nb = x.shape[0] // Lb
    xt = x.reshape(nb, Lb, C)
    Yl = torch.einsum("tu,buc->btc", H, xt)       # within-tile convolution
    E = torch.einsum("du,buc->bdc", R, xt)        # carry injection per tile
    Cst = _carry_prefix_tiles(carry, E, c0)       # states BEFORE tiles
    y = Yl + torch.einsum("td,bdc->btc", W, Cst)
    # final state after sample N-1 (exact despite the zero tail padding:
    # only inputs u <= ki enter Px)
    zf_state = Pc @ Cst[nb - 1] + Px @ xt[nb - 1]
    return y.reshape(nb * Lb, C)[:N], zf_state


def sosfilt_tileconv(sos, x: torch.Tensor, zi: torch.Tensor | None = None):
    """Cascade filter via the tile-conv tables. sos: host [k, 6] (float64
    tables, cached) or a [k, 6] tensor (tables in torch ops, differentiable);
    x: [N, C] on any device (float32; a tensor sos also takes float64);
    zi: scipy layout [k, C, 2] or None. Returns (y [N, C], zf [k, C, 2])."""
    N, C = x.shape
    if N == 0:
        raise ValueError("sosfilt_tileconv: empty input")
    Lb = _LB
    nb = -(-N // Lb)
    ki = (N - 1) % Lb
    if isinstance(sos, torch.Tensor):
        k = int(sos.shape[0])
        H, W, R, carry, Pc, Px, Vf, Vi = _traced_tables(
            sos.to(device=x.device, dtype=x.dtype), Lb, ki,
            max(int(nb - 1).bit_length(), 1))
    else:
        sos64 = np.ascontiguousarray(np.asarray(sos, np.float64))
        k = int(sos64.shape[0])
        key = (sos64.tobytes(), k, Lb)
        H, W, R, carry, Vf, Vi = _device_pack(*key, x.device)
        Pc, Px = _device_partial(*key, ki, x.device)
    xp = F.pad(x, (0, 0, 0, nb * Lb - N))
    c0 = (x.new_zeros((2 * k, C)) if zi is None
          else _zi_to_state(zi.to(x.dtype), Vi))
    y, zf_state = _tileconv_run(xp, H, W, R, carry, Pc, Px, c0, N, Lb)
    return y, _zf_from_state(zf_state, Vf)


# ---------------------------------------------------------------------------
# Tables of a coefficient tensor
# ---------------------------------------------------------------------------

def _traced_tables(sos: torch.Tensor, Lb: int, ki: int, n_carry_levels: int):
    """(H, W, R, carry, Pc, Px, Vf, Vi) of a [k, 6] tensor in torch ops of
    its dtype (port of ``ame_tpu/ops/tile_conv.py::_traced_tables``): the
    powers A^t, t < Lb, by log2(Lb) batched doublings, then the tables as
    in ``_tables_np``, the carry levels A^(Lb*2^j) by squaring, and the
    final-state tables of a track ending at within-tile offset ``ki``.
    Squaring in float32 is fine for the quality designs, whose poles sit
    well inside the unit circle."""
    A, B, Crow, dpass = _cascade_state_space(sos)
    Vi, Vf = _zi_transforms(sos)
    D = A.shape[0]
    eye = torch.eye(D, dtype=sos.dtype, device=sos.device)
    idx = torch.arange(Lb, device=sos.device)
    # A^t for t = 0 .. Lb-1 by doubling
    T = torch.where((idx == 0)[:, None, None], eye[None], A[None])
    shift = 1
    while shift < Lb:
        Ts = torch.cat([eye[None].expand(shift, D, D), T[:Lb - shift]])
        T = torch.matmul(T, Ts)
        shift *= 2
    AL = T[Lb - 1] @ A                                    # A^Lb
    h = torch.cat([dpass[None],
                   torch.einsum("j,tjm,m->t", Crow, T[:Lb - 1], B)])
    dif = idx[:, None] - idx[None, :]
    H = torch.where(dif >= 0, h[torch.clamp(dif, 0, Lb - 1)],
                    torch.zeros((), dtype=sos.dtype, device=sos.device))
    W = torch.einsum("j,tjm->tm", Crow, T)                # [Lb, D]
    R = torch.einsum("ujm,m->ju", torch.flip(T, [0]), B)  # [D, Lb]
    carry = []
    M = AL
    for _ in range(n_carry_levels):
        carry.append(M)
        M = M @ M
    Pc = T[ki] @ A                                        # A^(ki+1)
    Pxt = torch.einsum("ujm,m->ju", T[torch.clamp(ki - idx, 0, Lb - 1)], B)
    Px = torch.where((idx <= ki)[None, :], Pxt, torch.zeros_like(Pxt))
    return H, W, R, torch.stack(carry), Pc, Px, Vf, Vi
