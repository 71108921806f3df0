"""CUDA wedge-envelope kernel wrapper — the port's counterpart of the Pallas
kernel K1 (``ame_tpu/ops/limiter.py::_wedge_env_kernel``, driven by
``_wedge_env``).

One call computes one direction of the alimiter depth envelope,
env[n] = min_p a_p · s_p[n] with s_p[n] = max(dep[n], ρ_p · s_p[n∓1]), as a
tiled (max, ×) scan in three launches (``ame_tpu_torch/csrc/wedge_env.cu``):
tiles of ``_TP`` rows x ``_SUB`` samples in shared memory (``_geometry``),
one thread walking each row from zero state, a log-depth scan of the row
ends inside the tile, a scan of the tile totals across tiles in chunks of
``_CARRY_THREADS``, and a re-walk of every row from its carry. The host
side rounds the pieces to f32 and builds every decay power the scans use in
float64 from the f32 ρ_p (``_power_table``), rounded to f32 once and kept
on the device per piece set, so nothing is uploaded per call.

``wedge_env_cuda`` launches the kernel for CUDA tensors and raises for any
other; the plain PyTorch version is ``wedge_env_plain`` (one
``window.release_scan`` per piece, as ``_alimiter_depth`` runs them off the
TPU). ``wedge_env_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ame_tpu_torch.ops import _build
from ame_tpu_torch.ops import window as W

_SUB = 32            # samples per walker thread (SUB in wedge_env.cu)
_LOG_TP = 8          # 2^8 walker threads (rows) per tile (LOG_TP)
_CARRY_THREADS = 1024  # tiles per chunk of the carry scan (CARRY_THREADS)
_PW = 8              # floats per power-table row (PW)
_PIECES = 6          # len(limiter._wedge_pieces(w)); the kernel is built for it


def _geometry(n: int):
    """(sub, log_tp, nb): rows of ``sub`` samples, 2^log_tp rows a tile,
    nb tiles over n samples."""
    tile = _SUB << _LOG_TP
    return _SUB, _LOG_TP, -(-n // tile)


def _piece_arrays(pieces: tuple):
    """(a, rho) of the pieces, each rounded to float32 as the kernel walks."""
    return (np.asarray([p[0] for p in pieces], np.float32),
            np.asarray([p[1] for p in pieces], np.float32))


@functools.lru_cache(maxsize=64)
def _power_table(pieces: tuple, sub: int, log_tp: int) -> np.ndarray:
    """float32 [2^log_tp + 39, _PW]: row j = ρ^(sub·j) for j <= 2^log_tp
    (the in-tile scan, the warps' lane powers, the start states), then
    ρ^(T·k) for k <= 32 and ρ^(32·T·2^l) for l < 5, T = sub·2^log_tp (the
    carry scan across tiles), the 6 pieces in columns 0-5.

    Each entry is the float64 power of the f32 ρ_p the walks multiply by,
    rounded to f32 once: in [0, 1], and 0 where it underflows."""
    rho = _piece_arrays(pieces)[1].astype(np.float64)
    tp = 1 << log_tp
    tile = sub * tp
    exps = np.concatenate([sub * np.arange(tp + 1), tile * np.arange(33),
                           32 * tile * (1 << np.arange(5))]).astype(np.float64)
    table = np.zeros((exps.shape[0], _PW), np.float32)
    table[:, :len(pieces)] = (rho[None, :] ** exps[:, None]).astype(np.float32)
    return table


@functools.lru_cache(maxsize=16)
def _device_powers(pieces: tuple, device: torch.device) -> torch.Tensor:
    """``_power_table`` at the kernel's geometry on the card, uploaded once
    per piece set."""
    return torch.from_numpy(_power_table(pieces, _SUB, _LOG_TP)).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("wedge_env")["path"]))
    lib.wedge_env_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_void_p])
    lib.wedge_env_f32.restype = ctypes.c_int
    lib.wedge_env_error.argtypes = [ctypes.c_int]
    lib.wedge_env_error.restype = ctypes.c_char_p
    return lib


def wedge_env_plain(dep: torch.Tensor, pieces, reverse: bool) -> torch.Tensor:
    """min_p release_scan(a_p · dep, ρ_p), run backwards when ``reverse``:
    the form ``_alimiter_depth`` takes off the TPU."""
    u = torch.flip(dep, [0]) if reverse else dep
    env = None
    for a, rho in pieces:
        s = W.release_scan(u * a, rho)
        env = s if env is None else torch.minimum(env, s)
    return torch.flip(env, [0]) if reverse else env


def wedge_env_cuda(dep: torch.Tensor, pieces, reverse: bool) -> torch.Tensor:
    """One direction of the wedge envelope on the card. dep: contiguous [N]
    float32 CUDA tensor (depths >= 0); pieces: the 6 host (a, rho) pairs
    of ``limiter._wedge_pieces``. Returns env [N]."""
    if not dep.is_cuda:
        raise ValueError("wedge_env_cuda needs a CUDA tensor; CPU tensors go "
                         "through wedge_env_plain")
    if dep.dtype != torch.float32 or dep.ndim != 1 or not dep.is_contiguous():
        raise ValueError(f"wedge_env_cuda needs a contiguous [N] float32 "
                         f"tensor, got {dep.dtype} {tuple(dep.shape)}")
    pieces = tuple((float(a), float(r)) for a, r in pieces)
    P = len(pieces)
    if P != _PIECES:
        raise ValueError(f"wedge_env_cuda takes {_PIECES} pieces, got {P}")
    n = dep.shape[0]
    if n == 0:
        raise ValueError("wedge_env_cuda: empty input")
    if dep.data_ptr() % 16:
        dep = dep.clone()    # a view at an odd offset: the tiles load 16 bytes
    sub, log_tp, nb = _geometry(n)
    a, rho = _piece_arrays(pieces)
    params = np.concatenate([a, rho])
    powers = _device_powers(pieces, dep.device)
    lib = _lib()
    env = torch.empty_like(dep)
    # one scratch allocation: S [nb, 6, 2^log_tp], E and C [6, nb]
    scratch = torch.empty(nb * P * ((1 << log_tp) + 2), dtype=dep.dtype,
                          device=dep.device)
    ptr, step = scratch.data_ptr(), scratch.element_size()
    E = ptr + nb * P * (1 << log_tp) * step
    C = E + nb * P * step
    with torch.cuda.device(dep.device):
        stream = torch.cuda.current_stream(dep.device).cuda_stream
        err = lib.wedge_env_f32(dep.data_ptr(), env.data_ptr(), ptr, E, C,
                                powers.data_ptr(), n, P, sub, log_tp,
                                int(reverse), params.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"wedge_env_f32 launch failed: CUDA error {err} "
                           f"({lib.wedge_env_error(err).decode()})")
    wedge_env_cuda.launches += 1
    return env


wedge_env_cuda.launches = 0
