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

Coefficients may also be a tensor (the quality designs of a tensor gain,
``models/automaster.py``): ``_cascade_state_space`` and ``_zi_transforms``
build the same state space from a [k, 6] tensor with torch ops, so the
plain tile-conv route is differentiable in ``sos`` (CPU tensors), and on
the card ``SosfiltFn`` runs the kernel forward with a hand-written
backward made of kernels (``ops/cascade_scan.py`` in reverse,
``ops/sos_grad.py``).
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


def _section_terms(sos: torch.Tensor, i: int):
    """Section i of a [k, 6] tensor: (b0, c1, c2, is_complex, alpha, beta)
    with the coupled form's beta where the poles are complex (1 elsewhere,
    so no NaN reaches a gradient)."""
    b0, b1, b2 = sos[i, 0], sos[i, 1], sos[i, 2]
    a1, a2 = sos[i, 4], sos[i, 5]
    alpha = -a1 * 0.5
    beta_sq = a2 - alpha * alpha
    is_complex = beta_sq > 1e-12
    beta = torch.sqrt(torch.where(is_complex, beta_sq,
                                  torch.ones_like(beta_sq)))
    return b0, b1 - a1 * b0, b2 - a2 * b0, is_complex, alpha, beta


def _cascade_state_space(sos: torch.Tensor):
    """``_state_space_np`` of a [k, 6] tensor, in torch ops of its dtype
    (port of ``ame_tpu/ops/scan_iir.py::_cascade_state_space``): (A [D, D],
    B [D], Crow [D], d) with D = 2k, each section in the coupled form where
    its poles are complex and the companion form where they are real,
    chosen per section with ``torch.where``."""
    k = sos.shape[0]
    D = 2 * k
    zero = sos.new_zeros(())
    one = sos.new_ones(())
    A_rows = [[zero] * D for _ in range(D)]
    B_col = [zero] * D
    g = one                      # du_i/dx
    r = [zero] * D               # du_i/ds
    for i in range(k):
        b0, c1, c2, cplx, alpha, beta = _section_terms(sos, i)
        a1, a2 = sos[i, 4], sos[i, 5]
        i1, i2 = 2 * i, 2 * i + 1
        a_11 = torch.where(cplx, alpha, -a1)
        a_12 = torch.where(cplx, -beta, one)
        a_21 = torch.where(cplx, beta, -a2)
        a_22 = torch.where(cplx, alpha, zero)
        b_2 = torch.where(cplx, -(alpha * c1 + c2) / beta, c2)
        A_rows[i1] = [c1 * rj for rj in r]
        A_rows[i1][i1] = A_rows[i1][i1] + a_11
        A_rows[i1][i2] = A_rows[i1][i2] + a_12
        B_col[i1] = c1 * g
        A_rows[i2] = [b_2 * rj for rj in r]
        A_rows[i2][i1] = A_rows[i2][i1] + a_21
        A_rows[i2][i2] = A_rows[i2][i2] + a_22
        B_col[i2] = b_2 * g
        r = [b0 * rj for rj in r]
        r[i1] = r[i1] + one
        g = b0 * g
    A = torch.stack([torch.stack(row) for row in A_rows])
    return A, torch.stack(B_col), torch.stack(r), g


def _zi_transforms(sos: torch.Tensor):
    """(Vi, Vf) [k, 2, 2] of a [k, 6] tensor: scipy zi -> internal state
    and back (port of ``ame_tpu/ops/scan_iir.py::_zi_transforms``)."""
    one = sos.new_ones(())
    zero = sos.new_zeros(())
    vi, vf = [], []
    for i in range(sos.shape[0]):
        _, _, _, cplx, alpha, beta = _section_terms(sos, i)
        vi.append(torch.stack([
            torch.stack([one, zero]),
            torch.stack([torch.where(cplx, -alpha / beta, zero),
                         torch.where(cplx, -1.0 / beta, one)])]))
        vf.append(torch.stack([
            torch.stack([one, zero]),
            torch.stack([torch.where(cplx, -alpha, zero),
                         torch.where(cplx, -beta, one)])]))
    return torch.stack(vi), torch.stack(vf)


def _zi_to_state(zi: torch.Tensor, Vi: torch.Tensor) -> torch.Tensor:
    """scipy-layout zi [k, C, 2] -> internal coupled state [D, C]."""
    zi_int = torch.einsum("kab,kcb->kac", Vi, zi)        # [k, 2, C]
    k, _, C = zi_int.shape
    return zi_int.reshape(2 * k, C)


def _zf_from_state(s: torch.Tensor, Vf: torch.Tensor) -> torch.Tensor:
    """internal [D, C] -> scipy layout [k, C, 2]."""
    D, C = s.shape
    return torch.einsum("kab,kbc->kca", Vf, s.reshape(D // 2, 2, C))


def _filter(sos64: np.ndarray, x: torch.Tensor, zi=None, reverse=False,
            cached=True):
    """One cascade of at most 8 sections over x [N, C] on x's device: the
    kernel on the card, the plain tile-conv on the CPU (run on the flipped
    input when ``reverse``: the same recurrence from the last sample back,
    from zero state there). ``cached`` False prepares the kernel's tables
    for this call only (coefficients that change every call)."""
    if x.is_cuda:
        from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
        return sosfilt_cuda(sos64 if cached else torch.from_numpy(sos64),
                            x.contiguous(), zi, reverse=reverse)
    if x.device.type != "cpu":
        raise ValueError(f"sosfilt: unsupported device {x.device}")
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv
    if not reverse:
        return sosfilt_tileconv(sos64, x, zi)
    y, zf = sosfilt_tileconv(sos64, torch.flip(x, [0]), zi)
    return torch.flip(y, [0]), zf


class SosfiltFn(torch.autograd.Function):
    """A cascade of at most 8 sections from zero state (or from ``zi``, which
    is not differentiated) with a hand-written backward.

    With u_0 = x, u_s the output of section s = (b0, b1, b2, 1, a1, a2) and
    g_s = dL/du_s:

      dL/db_j = sum_n g_s[n] v_s[n-j],   v_s = u_{s-1} filtered by 1/A_s(z)
      dL/da_j = -sum_n g_s[n] w_s[n-j],  w_s = u_s filtered by 1/A_s(z)
      g_{s-1} = section s run backward in time on g_s (zero state at the end)

    and dL/da0 = 0 (the designs divide by a0 before they stack the row).
    Only dL/dx needed (fixed coefficients): one reverse launch of the whole
    cascade. dL/dsos needed: the section outputs u_1 .. u_{k-1} are
    recomputed (k - 1 forward launches of one section; the forward keeps
    only x and y, 2 [N, C] tensors), then per section one all-pole launch
    on [u_{s-1}, u_s] as [N, 2C] columns, one ``sos_grad`` reduction and
    one reverse launch (the last one only when x needs its gradient).

    On the card every step is a kernel launch; on the CPU the same backward
    runs the plain versions (tile-conv on the flipped signal,
    ``sos_grad_plain``).

    apply(x, sos_t, sos64, zi): sos_t the [k, 6] tensor the gradient goes
    to (None for host coefficients), sos64 its float64 host copy. Returns
    (y, zf); zf is not differentiable."""

    @staticmethod
    def forward(ctx, x, sos_t, sos64, zi):
        cached = sos_t is None
        y, zf = _filter(sos64, x, zi, cached=cached)
        ctx.sos64, ctx.cached = sos64, cached
        ctx.sos_meta = (None if cached else (sos_t.device, sos_t.dtype))
        ctx.save_for_backward(x, y)
        ctx.mark_non_differentiable(zf)
        return y, zf

    @staticmethod
    def backward(ctx, gy, gzf):
        x, y = ctx.saved_tensors
        sos64, cached = ctx.sos64, ctx.cached
        need_x, need_sos = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        g = gy.contiguous()
        if not need_sos:
            return (_filter(sos64, g, reverse=True, cached=cached)[0]
                    if need_x else None), None, None, None
        from ame_tpu_torch.ops.sos_grad import sos_grad
        k, C = sos64.shape[0], x.shape[1]
        us = [x]
        for s in range(k - 1):
            us.append(_filter(sos64[s:s + 1], us[-1], cached=False)[0])
        us.append(y)
        sums = [None] * k
        for s in reversed(range(k)):
            a1, a2 = sos64[s, 4], sos64[s, 5]
            allpole = np.array([[1.0, 0.0, 0.0, 1.0, a1, a2]])
            vw = _filter(allpole, torch.cat([us[s], us[s + 1]], dim=1),
                         cached=False)[0]
            sums[s] = sos_grad(g, vw[:, :C], vw[:, C:])
            if s > 0 or need_x:
                g = _filter(sos64[s:s + 1], g, reverse=True,
                            cached=False)[0]
        sums = torch.stack(sums)                             # [k, 5]
        gsos = torch.cat([sums[:, :3], torch.zeros_like(sums[:, :1]),
                          sums[:, 3:]], dim=1)
        return (g if need_x else None, gsos.to(*ctx.sos_meta), None, None)


def sosfilt(sos, x: torch.Tensor, zi=None):
    """Cascade of biquads with scipy ``sosfilt`` semantics along axis 0.

    Args:
      sos: [k, 6] coefficients (a0 normalized to 1): host numpy, or a
        tensor (which may require grad).
      x: [N, C] float32 tensor.
      zi: scipy-layout initial state [k, C, 2], or None for zero state.

    Returns:
      (y [N, C], zf [k, C, 2]) on x's device.

    Routes: host coefficients and an x that needs no gradient take the
    kernel on the card (``sosfilt_cuda``) and the plain tile-conv on the
    CPU; on the card a tensor ``sos`` or an x that needs its gradient goes
    through ``SosfiltFn`` (the kernel with its hand-written backward); on
    the CPU a tensor ``sos`` builds the tile-conv tables in torch ops
    (``tile_conv._traced_tables``), which autograd differentiates.

    A cascade of more than the kernel's 8 sections (an LR4 band of a G-band
    tree has up to 2(G-1)) runs as consecutive pieces of at most 8, each
    filtering the one before's output, on either device: composing the
    pieces is the cascade, and zf is the pieces' zf in order.
    """
    from ame_tpu_torch.ops.cascade_scan import _MAX_SECTIONS
    if isinstance(sos, torch.Tensor):
        sos64 = sos.detach().to("cpu", torch.float64).numpy()
    else:
        sos = sos64 = np.ascontiguousarray(np.asarray(sos, np.float64))
    if sos64.ndim != 2 or sos64.shape[1] != 6:
        raise ValueError(f"sos must be [k, 6], got {sos64.shape}")
    if x.ndim != 2:
        raise ValueError(f"x must be [N, C], got {tuple(x.shape)}")
    if zi is not None:
        if isinstance(sos, torch.Tensor) and sos.requires_grad:
            raise ValueError("sosfilt: zi is not differentiated; a sos that "
                             "requires grad takes zero initial state")
        zi = torch.as_tensor(zi, dtype=torch.float32,
                             device=x.device).contiguous()
    return _sosfilt(sos, sos64, x, zi, _MAX_SECTIONS)


def _sosfilt(sos, sos64: np.ndarray, x: torch.Tensor, zi, max_sections: int):
    if sos64.shape[0] > max_sections:
        zfs = []
        for i in range(0, sos64.shape[0], max_sections):
            piece = slice(i, i + max_sections)
            x, zf = _sosfilt(sos[piece], np.ascontiguousarray(sos64[piece]),
                             x, None if zi is None else zi[piece],
                             max_sections)
            zfs.append(zf)
        return x, torch.cat(zfs)
    tensor_sos = isinstance(sos, torch.Tensor)
    if x.is_cuda:
        if tensor_sos or x.requires_grad:
            return SosfiltFn.apply(x, sos if tensor_sos else None, sos64, zi)
        from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
        return sosfilt_cuda(sos64, x.contiguous(), zi)
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
