"""Cascade IIR filtering: the state-space builder and the one public
``sosfilt`` that every stage of the port calls.

Port of ``ame_tpu/ops/scan_iir.py``: ``_state_space_np`` (the float64 host
construction of the coupled-form cascade state space), the scipy zi/zf
transforms of ``_zi_transforms``, ``biquad_scan`` (one biquad with a
carried zi: the streaming attack smoother) and ``sosfilt_chunked`` (chunked
compat's per-chunk state resets). The JAX module's scan engines are not
ported: in the port a cascade runs through one of two implementations of the
same math,

  * ``ops/cascade_scan.py`` — the hand-written CUDA kernel (counterpart of
    the Pallas kernel in ``ame_tpu/ops/pallas_scan.py``), for CUDA tensors;
  * ``ops/tile_conv.py`` — the plain PyTorch tile-convolution version, for
    CPU tensors (and called directly on the card to check the kernel).

``sosfilt`` picks by the device the input lies on; there is no switch and no
fallback from the kernel to the plain version.

A k-section SOS cascade is one linear system with a 2k-dim state
(s_after = A s + B x, y = d x + Crow s, s = the state before the sample).
Each section's 2x2 block is similarity-transformed to the coupled (rotation)
form when its poles are complex, so powers of A stay bounded even for
near-unit-circle poles; the first state component of each section equals
the TDF-II s1, so the scipy ``zi`` convention maps over with the per-section
2x2 matrices Vi (scipy -> internal) and Vf (internal -> scipy).
"""

from __future__ import annotations

import numpy as np
import torch


def _section_forms(sos: np.ndarray):
    """Per-section internal forms, float64.

    Section i (b0, b1, b2, 1, a1, a2) in TDF-II form:
        y_i   = b0*u_i + s1_i
        s1_i' = (b1 - a1*b0)*u_i - a1*s1_i + s2_i
        s2_i' = (b2 - a2*b0)*u_i - a2*s1_i
    with u_1 = x, u_{i+1} = y_i. Complex-pole sections use the coupled block
    [[α, -β], [β, α]] (α = -a1/2, β = sqrt(a2 - α²)) via V = [[1, 0], [-α, -β]];
    real-pole sections keep the companion block.

    Returns (sec [k, 7] rows (b0, bb1, bb2, a11, a12, a21, a22) of
    y = b0*u + s1, s1' = a11*s1 + a12*s2 + bb1*u, s2' = a21*s1 + a22*s2 + bb2*u;
    Vf, Vi [k, 2, 2])."""
    sos = np.asarray(sos, np.float64)
    k = sos.shape[0]
    sec = np.zeros((k, 7))
    Vf = np.zeros((k, 2, 2))
    Vi = np.zeros((k, 2, 2))
    for i in range(k):
        b0, b1, b2, _, a1, a2 = sos[i]
        c1 = b1 - a1 * b0
        c2 = b2 - a2 * b0
        alpha = -a1 * 0.5
        beta_sq = a2 - alpha * alpha
        if beta_sq > 1e-12:
            beta = np.sqrt(beta_sq)
            sec[i] = [b0, c1, -(alpha * c1 + c2) / beta,
                      alpha, -beta, beta, alpha]
            Vf[i] = [[1.0, 0.0], [-alpha, -beta]]
            Vi[i] = [[1.0, 0.0], [-alpha / beta, -1.0 / beta]]
        else:
            sec[i] = [b0, c1, c2, -a1, 1.0, -a2, 0.0]
            Vf[i] = np.eye(2)
            Vi[i] = np.eye(2)
    return sec, Vf, Vi


def _state_space_np(sos: np.ndarray):
    """float64 cascade state space (A [D,D], B [D], Crow [D], d) with D = 2k,
    plus the per-section zi transforms Vf, Vi [k, 2, 2]."""
    sec, Vf, Vi = _section_forms(sos)
    return (*_compose_sections(sec), Vf, Vi)


def _compose_sections(sec: np.ndarray):
    """(A, B, Crow, d) of the cascade of ``_section_forms`` rows, float64."""
    sec = np.asarray(sec, np.float64)
    k = sec.shape[0]
    D = 2 * k
    A = np.zeros((D, D))
    B = np.zeros(D)
    g = 1.0                      # du_i/dx
    r = np.zeros(D)              # du_i/ds
    for i in range(k):
        b0, bb1, bb2, a11, a12, a21, a22 = sec[i]
        i1, i2 = 2 * i, 2 * i + 1
        A[i1] = bb1 * r
        A[i1, i1] += a11
        A[i1, i2] += a12
        B[i1] = bb1 * g
        A[i2] = bb2 * r
        A[i2, i1] += a21
        A[i2, i2] += a22
        B[i2] = bb2 * g
        r = b0 * r
        r[i1] += 1.0
        g = b0 * g
    return A, B, r, g


def _zi_to_state(zi: torch.Tensor, Vi: torch.Tensor) -> torch.Tensor:
    """scipy-layout zi [k, C, 2] -> internal coupled state [D, C]."""
    zi_int = torch.einsum("kab,kcb->kac", Vi, zi)        # [k, 2, C]
    k, _, C = zi_int.shape
    return zi_int.reshape(2 * k, C)


def _zf_from_state(s: torch.Tensor, Vf: torch.Tensor) -> torch.Tensor:
    """internal [D, C] -> scipy layout [k, C, 2]."""
    D, C = s.shape
    return torch.einsum("kab,kbc->kca", Vf, s.reshape(D // 2, 2, C))


def sosfilt(sos, x: torch.Tensor, zi=None):
    """Cascade of biquads with scipy ``sosfilt`` semantics along axis 0.

    Args:
      sos: [k, 6] host coefficients (a0 normalized to 1).
      x: [N, C] float32 tensor.
      zi: scipy-layout initial state [k, C, 2], or None for zero state.

    Returns:
      (y [N, C], zf [k, C, 2]) on x's device.

    A cascade of more than the kernel's 8 sections (an LR4 band of a G-band
    tree has up to 2(G-1)) runs as consecutive pieces of at most 8, each
    filtering the one before's output, on either device: composing the
    pieces is the cascade, and zf is the pieces' zf in order.
    """
    from ame_tpu_torch.ops.cascade_scan import _MAX_SECTIONS
    sos = np.ascontiguousarray(np.asarray(sos, np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [k, 6], got {sos.shape}")
    if x.ndim != 2:
        raise ValueError(f"x must be [N, C], got {tuple(x.shape)}")
    if zi is not None:
        zi = torch.as_tensor(zi, dtype=torch.float32,
                             device=x.device).contiguous()
    if sos.shape[0] > _MAX_SECTIONS:
        zfs = []
        for i in range(0, sos.shape[0], _MAX_SECTIONS):
            x, zf = sosfilt(sos[i:i + _MAX_SECTIONS], x,
                            None if zi is None else zi[i:i + _MAX_SECTIONS])
            zfs.append(zf)
        return x, torch.cat(zfs)
    if x.is_cuda:
        from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
        return sosfilt_cuda(sos, x.contiguous(), zi)
    if x.device.type == "cpu":
        from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv
        return sosfilt_tileconv(sos, x, zi)
    raise ValueError(f"sosfilt: unsupported device {x.device}")


def biquad_scan(x: torch.Tensor, coeffs, zi=None):
    """One biquad along axis 0: a k = 1 ``sosfilt``.

    coeffs: host [6] (b0, b1, b2, a0, a1, a2), a0 == 1. x: [N, C]. zi:
    scipy lfilter layout [C, 2], or None. Returns (y [N, C], zf [C, 2])."""
    sos = np.asarray(coeffs, np.float64).reshape(1, 6)
    y, zf = sosfilt(sos, x, None if zi is None else zi[None])
    return y, zf[0]


def sosfilt_chunked(sos, x: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """``sosfilt`` with the filter state reset every ``chunk_len`` samples
    along axis 0: the reference's 30 s segment loop, each chunk filtered
    from zero state (quirk Q6). The chunks become columns, [chunk_len,
    n_chunks * C] (column j * C + c is channel c of chunk j, the last chunk
    zero-padded), and go through the one ``sosfilt`` together. x: [N, C];
    returns y [N, C]."""
    n, C = x.shape
    nc = -(-n // chunk_len)
    cols = torch.nn.functional.pad(x, (0, 0, 0, nc * chunk_len - n)).reshape(
        nc, chunk_len, C).permute(1, 0, 2).reshape(chunk_len, nc * C)
    y, _ = sosfilt(sos, cols.contiguous())
    return y.reshape(chunk_len, nc, C).permute(1, 0, 2).reshape(
        nc * chunk_len, C)[:n]
