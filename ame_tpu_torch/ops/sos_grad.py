"""Coefficient gradient of one biquad section: five lag correlations
(``csrc/sos_grad.cu``), part of the backward of the cascade kernel
(``scan_iir.SosfiltFn``).

For g, v, w [N, C] float32 (the cotangent of a section's output, its input
and its output each filtered by 1/A(z)) it returns, as float64,

    [sum g[n] v[n],  sum g[n] v[n-1],  sum g[n] v[n-2],
     -sum g[n] w[n-1],  -sum g[n] w[n-2]]

summed over n and the C columns, with v, w zero before sample 0:
dL/d(b0, b1, b2, a1, a2). Products are formed in float32 and added in
float64, by two launches and no atomics (a partial row a block over a
partition fixed by N, then one small launch adds them in block order), so
the same inputs give the same sums on every call.

``sos_grad_cuda`` launches the kernel for CUDA tensors and raises for any
other; ``sos_grad_plain`` is its plain PyTorch version; ``sos_grad`` picks
by device. ``sos_grad_cuda.launches`` counts the calls that launched it,
``sos_grad_cuda.vector_launches`` those of them that took the vector
route. g, v and w may be column slices of wider tensors (row stride >= C,
column stride 1). The vector route (``vector_route``) takes the layout the
backward passes, v and w the two halves of one [N, 2C] all-pole output at
C <= 2 with aligned rows, in one wide load a row; any other layout takes
the general route, which gives the same sums bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ame_tpu_torch.ops import _build

MAX_C = 64                       # csrc/sos_grad.cu's MAX_C


def _lagged(t: torch.Tensor, j: int) -> torch.Tensor:
    """t delayed by j samples along axis 0 (zeros before sample 0)."""
    if j == 0:
        return t
    return torch.cat([t.new_zeros((j,) + t.shape[1:]), t[:-j]], dim=0)


def sos_grad_plain(g: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """The five sums on any device: float32 products, float64 sums."""
    def corr(a, j):
        return torch.sum((g * _lagged(a, j)).to(torch.float64))
    return torch.stack([corr(v, 0), corr(v, 1), corr(v, 2),
                        -corr(w, 1), -corr(w, 2)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("sos_grad")["path"]))
    lib.sos_grad_f64.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3)
    lib.sos_grad_f64.restype = ctypes.c_int
    lib.sos_grad_blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.sos_grad_blocks.restype = ctypes.c_longlong
    lib.sos_grad_error.argtypes = [ctypes.c_int]
    lib.sos_grad_error.restype = ctypes.c_char_p
    return lib


def _row_stride(t: torch.Tensor, name: str, shape) -> int:
    if (t.dtype != torch.float32 or t.ndim != 2 or tuple(t.shape) != shape
            or (t.shape[1] > 1 and t.stride(1) != 1)
            or t.stride(0) < t.shape[1]):
        raise ValueError(f"sos_grad_cuda: {name} must be a float32 "
                         f"{list(shape)} tensor with unit column stride, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def vector_route(C: int, ld: tuple, ptr: tuple) -> bool:
    """Whether the kernel reads (g, v, w) by its vector route: C <= 2, w
    the C columns after v in the same rows (w = v + C, one row stride),
    v's rows aligned to 8C bytes and g's to 4C bytes. ``ld`` holds the row
    strides (elements) and ``ptr`` the byte addresses of g, v and w. Raises
    for a C the kernel does not take (1 <= C <= MAX_C)."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"sos_grad_cuda: C must be in 1..{MAX_C}, got {C}")
    (ldg, ldv, ldw), (pg, pv, pw) = ld, ptr
    return (C <= 2 and pw == pv + 4 * C and ldv == ldw
            and pv % (8 * C) == 0 and (4 * ldv) % (8 * C) == 0
            and pg % (4 * C) == 0 and (4 * ldg) % (4 * C) == 0)


def sos_grad_cuda(g: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """The five sums on the card: float64 [5] on g's device."""
    if not (g.is_cuda and v.device == g.device and w.device == g.device):
        raise ValueError("sos_grad_cuda needs CUDA tensors on one device; "
                         "CPU tensors go through sos_grad_plain")
    N, C = g.shape
    if N == 0 or C == 0:
        raise ValueError("sos_grad_cuda: empty input")
    ld = [_row_stride(t, name, (N, C))
          for t, name in ((g, "g"), (v, "v"), (w, "w"))]
    vector = vector_route(C, ld, (g.data_ptr(), v.data_ptr(), w.data_ptr()))
    lib = _lib()
    nblocks = lib.sos_grad_blocks(N, C)
    buf = torch.empty(nblocks * 5 + 5, dtype=torch.float64, device=g.device)
    out = buf[nblocks * 5:]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.sos_grad_f64(g.data_ptr(), v.data_ptr(), w.data_ptr(), N,
                               C, *ld, int(vector), buf.data_ptr(),
                               out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sos_grad launch failed: CUDA error {err} "
                           f"({lib.sos_grad_error(err).decode()})")
    sos_grad_cuda.launches += 1
    sos_grad_cuda.vector_launches += vector
    return out


sos_grad_cuda.launches = 0
sos_grad_cuda.vector_launches = 0


def sos_grad(g: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if g.is_cuda:
        return sos_grad_cuda(g, v, w)
    if g.device.type != "cpu":
        raise ValueError(f"sos_grad: unsupported device {g.device}")
    return sos_grad_plain(g, v, w)
