"""CUDA wedge-envelope kernel wrapper — the port's counterpart of the Pallas
kernel K1 (``ame_tpu/ops/limiter.py::_wedge_env_kernel``, driven by
``_wedge_env``).

One launch computes one direction of the alimiter depth envelope,
env[n] = min_p a_p · s_p[n] with s_p[n] = max(dep[n], ρ_p · s_p[n∓1]), as a
three-phase block scan (``ame_tpu_torch/csrc/wedge_env.cu``). The host side
rounds the pieces to f32 and builds ρ_p^TB in float64 from the f32 ρ_p.

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

# Samples per block: 8192 blocks at 2^23 samples for the carry walk.
_TB = 1024
_PIECES = 6       # len(limiter._wedge_pieces(w)); the kernel is built for it


@functools.lru_cache(maxsize=64)
def _kernel_params(pieces: tuple, tb: int) -> np.ndarray:
    """float32 [a_p..., rho_p..., rho_p^tb...] in the layout
    ``wedge_env_f32`` reads; rho^tb is the float64 power of the f32 rho."""
    a = np.asarray([p[0] for p in pieces], np.float32)
    rho = np.asarray([p[1] for p in pieces], np.float32)
    rho_tb = rho.astype(np.float64) ** tb
    return np.concatenate([a, rho, rho_tb.astype(np.float32)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("wedge_env")["path"]))
    lib.wedge_env_f32.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p])
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
    params = _kernel_params(pieces, _TB)
    lib = _lib()
    nb = -(-n // _TB)
    env = torch.empty_like(dep)
    e = torch.empty((P * max(nb - 1, 1),), dtype=dep.dtype, device=dep.device)
    carry = torch.empty((P * nb,), dtype=dep.dtype, device=dep.device)
    with torch.cuda.device(dep.device):
        stream = torch.cuda.current_stream(dep.device).cuda_stream
        err = lib.wedge_env_f32(dep.data_ptr(), env.data_ptr(), e.data_ptr(),
                                carry.data_ptr(), n, _TB, P, int(reverse),
                                params.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"wedge_env_f32 launch failed: CUDA error {err} "
                           f"({lib.wedge_env_error(err).decode()})")
    wedge_env_cuda.launches += 1
    return env


wedge_env_cuda.launches = 0
