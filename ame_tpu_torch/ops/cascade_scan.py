"""CUDA cascade-IIR kernel wrapper — the port's counterpart of the Pallas
kernel K5 (``ame_tpu/ops/pallas_scan.py::_kernel``, driven by
``sosfilt_pallas``).

The kernel (``ame_tpu_torch/csrc/cascade_scan.cu``) runs a k <= 8 section
biquad cascade per channel in f32. What bounds it on an H100 is bytes (x
in, y out: 0.040 ms at 2^23 stereo), provided enough independent chains
keep every SM busy, so it cuts time into sub-blocks of ``_SUB`` = 64
samples, one thread each (2^18 chains at 2^23 stereo), staged through
shared memory in tiles of P sub-blocks x CB channels (``_geometry``):

  1. each thread walks its sub-block from zero state; a log-depth scan
     over the tile's sub-blocks gives the in-tile prefixes;
  2. one block per channel stages the tile totals and one warp scans
     them, c_{b+1} = A^T c_b + E_b from zi: each lane folds a run of
     tiles, a shuffle scan over the lanes joins the runs;
  3. each thread re-runs its sub-block from S_{j-1} + A^(SUB*j) c_b and the
     tile is stored coalesced; zf comes from the last sample's thread.

Any N: the ragged edge is masked in the kernel.

The host side here designs everything the kernel reads in float64: the
per-section forms (``_kernel_sections``: coupled for complex poles,
triangular for real ones) and the scipy zi/zf transforms travel by value
as kernel parameters; the powers A^(SUB*2^l) and A^(T*2^l) of the
f32-rounded section rows, in the same basis, are rounded to f32 once and
kept on the device per (cascade, tile), so nothing is uploaded per call.

``sosfilt_cuda`` launches the kernel for CUDA tensors and raises for any
other; the plain PyTorch version is ``ops/tile_conv.sosfilt_tileconv``.
``reverse=True`` runs the same recurrence from the last sample back (the
kernel's REVERSE instantiation: the adjoint of the cascade, for
``scan_iir.SosfiltFn``); its plain version is the tile-conv on the flipped
input. ``sosfilt_cuda.launches`` counts the calls that launched the forward
kernel, ``sosfilt_cuda.reverse_launches`` those of the reverse one; a call
recorded into a CUDA graph counts once, at capture, and not at its
replays.

Coefficients given as a tensor (a fit's designs, new every step) are
fetched with one ``.cpu()`` and their tables prepared for that call only,
outside the caches, so they do not evict the fixed cascades' tables; the
power table then goes up through pinned memory without a sync.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ame_tpu_torch.ops import _build
from ame_tpu_torch.ops._branch import hold
from ame_tpu_torch.ops.scan_iir import _compose_sections, _section_forms

_SUB = 64           # samples per thread (SUB in cascade_scan.cu)
_MAX_THREADS = 256  # threads per tile block (P * CB)
_LOG_CARRY = 9      # the carry scan's powers A^(T*2^l), l <= 9
_MAX_SECTIONS = 8


def _geometry(C: int):
    """(CB, logP): a tile holds CB <= 4 channels and P = 2^logP >= _SUB
    sub-blocks of each, P * CB <= 256 threads."""
    CB = min(C, 4)
    logP = 8
    while (1 << logP) * CB > _MAX_THREADS:
        logP -= 1
    return CB, logP


def _kernel_sections(sos: np.ndarray):
    """``scan_iir._section_forms`` with every real-pole section moved from
    the companion block [[-a1, 1], [-a2, 0]] to a triangular one.

    Rounding the companion block to f32 can push a pole that sits just
    inside the unit circle outside it: the dynamic-mode K-weighting's
    high-pass pair (0.9999916, 0.9988645 at 44.1 kHz) becomes 1.00005, and
    the kernel's per-sample walk and its powers diverge. With
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


def _params_np(sos: np.ndarray) -> np.ndarray:
    """float32 parameter block in the layout ``cascade_scan_f32`` reads:
    k rows (b0, bb1, bb2, a11, a12, a21, a22), Vi [k, 2, 2], Vf [k, 2, 2]."""
    sec, Vf, Vi = _kernel_sections(sos)
    return np.concatenate([sec.ravel(), Vi.ravel(),
                           Vf.ravel()]).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _kernel_params(sos_bytes: bytes, k: int) -> np.ndarray:
    return _params_np(np.frombuffer(sos_bytes, np.float64).reshape(k, 6))


def _powers_np(sos: np.ndarray, logP: int) -> np.ndarray:
    """float32 [logP + _LOG_CARRY + 1, 2k, 2k]: A^(SUB*2^l) for l < logP
    (the in-tile scan and start states), then A^(T*2^l) for
    l <= _LOG_CARRY, T = SUB*2^logP (the carry scan across tiles).

    A is the cascade of the f32-rounded section rows the kernel walks, in
    its basis, so each power continues exactly the recurrence the walks
    ran; the powers are squared in float64 and rounded to f32 once."""
    sec = _kernel_sections(sos)[0].astype(np.float32)
    A = _compose_sections(sec)[0]
    out = []
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        M = np.linalg.matrix_power(A, _SUB)
        for _ in range(logP + _LOG_CARRY + 1):
            out.append(M)
            M = M @ M
    table = np.nan_to_num(np.stack(out), nan=0.0, posinf=0.0, neginf=0.0)
    return table.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _power_table(sos_bytes: bytes, k: int, logP: int) -> np.ndarray:
    return _powers_np(np.frombuffer(sos_bytes, np.float64).reshape(k, 6),
                      logP)


@functools.lru_cache(maxsize=64)
def _device_powers(sos_bytes: bytes, k: int, logP: int,
                   device: torch.device) -> torch.Tensor:
    """``_power_table`` on the card, uploaded once per cascade and tile."""
    return torch.from_numpy(_power_table(sos_bytes, k, logP)).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("cascade_scan")["path"]))
    lib.cascade_scan_f32.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_void_p])
    lib.cascade_scan_f32.restype = ctypes.c_int
    lib.cascade_scan_reverse_f32.argtypes = lib.cascade_scan_f32.argtypes
    lib.cascade_scan_reverse_f32.restype = ctypes.c_int
    lib.cascade_scan_error.argtypes = [ctypes.c_int]
    lib.cascade_scan_error.restype = ctypes.c_char_p
    return lib


def sosfilt_cuda(sos, x: torch.Tensor, zi: torch.Tensor | None = None,
                 reverse: bool = False):
    """Cascade filter on the card. sos: [k, 6] (k <= 8), host numpy (tables
    cached) or a tensor (tables for this call only); x: contiguous [N, C]
    float32 CUDA tensor; zi: scipy layout [k, C, 2] on x's device or None.
    ``reverse``: filter from sample N-1 down to 0 (zi is then the state
    after the last sample, zf the state after sample 0). Returns
    (y [N, C], zf [k, C, 2])."""
    if not x.is_cuda:
        raise ValueError("sosfilt_cuda needs a CUDA tensor; CPU tensors go "
                         "through scan_iir.sosfilt (plain tile-conv)")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"sosfilt_cuda needs a contiguous [N, C] float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    cached = not isinstance(sos, torch.Tensor)
    sos64 = (np.ascontiguousarray(np.asarray(sos, np.float64)) if cached
             else sos.detach().to("cpu", torch.float64).numpy())
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
    CB, logP = _geometry(C)
    if cached:
        key = sos64.tobytes()
        params = _kernel_params(key, k)
        powers = hold(_device_powers(key, k, logP, x.device))
    else:
        params = _params_np(sos64)
        powers = torch.from_numpy(_powers_np(sos64, logP)).pin_memory().to(
            x.device, non_blocking=True)
    lib = _lib()
    nb = -(-N // (_SUB << logP))
    D = 2 * k
    y = torch.empty_like(x)
    # one scratch allocation: zf [k, C, 2], S [nb, C, D, P], E, cst [nb, C, D]
    scratch = torch.empty(k * C * 2 + nb * C * D * ((1 << logP) + 2),
                          dtype=x.dtype, device=x.device)
    zf = scratch[:k * C * 2].view(k, C, 2)
    ptr, step = scratch.data_ptr(), scratch.element_size()
    S = ptr + k * C * 2 * step
    E = S + nb * C * D * (1 << logP) * step
    cst = E + nb * C * D * step
    # the kernels launch on x's device (a no-op switch on the current one)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch = (lib.cascade_scan_reverse_f32 if reverse
                  else lib.cascade_scan_f32)
        err = launch(
            x.data_ptr(), y.data_ptr(),
            None if zi is None else zi.data_ptr(), zf.data_ptr(), S, E, cst,
            powers.data_ptr(), N, C, k, CB, logP, params.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"cascade_scan launch failed: CUDA error "
                           f"{err} ({lib.cascade_scan_error(err).decode()})")
    if reverse:
        sosfilt_cuda.reverse_launches += 1
    else:
        sosfilt_cuda.launches += 1
    return y, zf


sosfilt_cuda.launches = 0
sosfilt_cuda.reverse_launches = 0
