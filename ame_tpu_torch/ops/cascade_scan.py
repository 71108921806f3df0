"""CUDA cascade-IIR kernel wrapper — the port's counterpart of the Pallas
kernel K5 (``ame_tpu/ops/pallas_scan.py::_kernel``, driven by
``sosfilt_pallas``).

The kernel (``ame_tpu_torch/csrc/cascade_scan.cu``) runs a k <= 8 section
biquad cascade per channel in f32 as a three-phase block scan: block end
states from zero state, a per-channel carry walk c_{b+1} = A^TB c_b + e_b,
and a re-run of every block from its carry that writes y (and zf from the
last block). Any N: the ragged last block is masked in the kernel.

The host side here designs everything the kernel reads in float64: the
per-section forms (``_kernel_sections``: coupled for complex poles,
triangular for real ones), A^TB in the same basis, and the scipy zi/zf
transforms. They travel to the kernel by value as
kernel parameters, so nothing is uploaded per call.

``sosfilt_cuda`` launches the kernel for CUDA tensors and raises for any
other; the plain PyTorch version is ``ops/tile_conv.sosfilt_tileconv``.
``sosfilt_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ame_tpu_torch.ops import _build
from ame_tpu_torch.ops.scan_iir import _compose_sections, _section_forms

# Time samples per block. The same block length K5 used on the TPU; at
# 2^23 samples it gives 2048 blocks per channel for the carry walk.
_TB = 4096
_MAX_SECTIONS = 8


def _kernel_sections(sos: np.ndarray):
    """``scan_iir._section_forms`` with every real-pole section moved from
    the companion block [[-a1, 1], [-a2, 0]] to a triangular one.

    Rounding the companion block to f32 can push a pole that sits just
    inside the unit circle outside it: the dynamic-mode K-weighting's
    high-pass pair (0.9999916, 0.9988645 at 44.1 kHz) becomes 1.00005, and
    the kernel's per-sample walk and its A^tb carry diverge. With
    z = s2 + q·s1, q a real pole (α when the pair is within 1e-12 of
    double), the block is [[-a1 - q, 1], [-(q² + a1·q + a2), q]]: upper
    triangular, its diagonal the two poles, so the f32 rows keep them where
    they are. The first state component is still the TDF-II s1."""
    sec, Vf, Vi = _section_forms(sos)
    for i, (b0, b1, b2, _, a1, a2) in enumerate(np.asarray(sos, np.float64)):
        alpha = -a1 * 0.5
        beta_sq = a2 - alpha * alpha
        if beta_sq > 1e-12:                 # complex: the coupled form
            continue
        q = alpha + np.copysign(np.sqrt(max(-beta_sq, 0.0)), alpha)
        c1, c2 = b1 - a1 * b0, b2 - a2 * b0
        sec[i] = [b0, c1, q * c1 + c2, -a1 - q, 1.0,
                  -(q * q + a1 * q + a2), q]
        Vi[i] = [[1.0, 0.0], [q, 1.0]]
        Vf[i] = [[1.0, 0.0], [-q, 1.0]]
    return sec, Vf, Vi


@functools.lru_cache(maxsize=256)
def _kernel_params(sos_bytes: bytes, k: int, tb: int) -> np.ndarray:
    """float32 parameter block in the layout ``cascade_scan_f32`` reads:
    k rows (b0, bb1, bb2, a11, a12, a21, a22), A^tb [2k, 2k], Vi, Vf.

    A^tb is the float64 power of the cascade the kernel actually runs, i.e.
    of the f32-rounded section rows, so the block carry continues exactly
    the recurrence each block ran."""
    sos = np.frombuffer(sos_bytes, np.float64).reshape(k, 6)
    sec, Vf, Vi = _kernel_sections(sos)
    sec = sec.astype(np.float32)
    A = _compose_sections(sec)[0]
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        AT = np.linalg.matrix_power(A, tb)
    AT = np.nan_to_num(AT, nan=0.0, posinf=0.0, neginf=0.0)
    return np.concatenate([sec.ravel(), AT.ravel(), Vi.ravel(),
                           Vf.ravel()]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("cascade_scan")["path"]))
    lib.cascade_scan_f32.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p])
    lib.cascade_scan_f32.restype = ctypes.c_int
    lib.cascade_scan_error.argtypes = [ctypes.c_int]
    lib.cascade_scan_error.restype = ctypes.c_char_p
    return lib


def sosfilt_cuda(sos, x: torch.Tensor, zi: torch.Tensor | None = None):
    """Cascade filter on the card. sos: host [k, 6] (k <= 8); x: contiguous
    [N, C] float32 CUDA tensor; zi: scipy layout [k, C, 2] on x's device or
    None. Returns (y [N, C], zf [k, C, 2])."""
    if not x.is_cuda:
        raise ValueError("sosfilt_cuda needs a CUDA tensor; CPU tensors go "
                         "through scan_iir.sosfilt (plain tile-conv)")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"sosfilt_cuda needs a contiguous [N, C] float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    sos64 = np.ascontiguousarray(np.asarray(sos, np.float64))
    k = int(sos64.shape[0])
    if sos64.shape != (k, 6) or not 1 <= k <= _MAX_SECTIONS:
        raise ValueError(f"sos must be [k, 6] with 1 <= k <= {_MAX_SECTIONS},"
                         f" got {sos64.shape}")
    N, C = x.shape
    if N == 0 or C == 0:
        raise ValueError("sosfilt_cuda: empty input")
    if zi is not None and (zi.device != x.device or zi.dtype != torch.float32
                           or tuple(zi.shape) != (k, C, 2)
                           or not zi.is_contiguous()):
        raise ValueError(f"zi must be a contiguous float32 [{k}, {C}, 2] "
                         f"tensor on {x.device}")
    params = _kernel_params(sos64.tobytes(), k, _TB)
    lib = _lib()
    nb = -(-N // _TB)
    y = torch.empty_like(x)
    zf = torch.empty((k, C, 2), dtype=x.dtype, device=x.device)
    e = torch.empty((max(nb - 1, 1), C, 2 * k), dtype=x.dtype,
                    device=x.device)
    cst = torch.empty((nb, C, 2 * k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cascade_scan_f32(
            x.data_ptr(), y.data_ptr(),
            None if zi is None else zi.data_ptr(), zf.data_ptr(),
            e.data_ptr(), cst.data_ptr(), N, C, k, _TB,
            params.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"cascade_scan_f32 launch failed: CUDA error "
                           f"{err} ({lib.cascade_scan_error(err).decode()})")
    sosfilt_cuda.launches += 1
    return y, zf


sosfilt_cuda.launches = 0
