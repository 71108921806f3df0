"""Sample-rate conversion on the device (the Musicologist's 22 050 Hz input).

Port of ``ame_tpu/ops/resample.py``: windowed-sinc interpolation evaluated
directly at the output positions. Each output sample gathers ``taps``
neighbouring input samples and dots them with sinc x Kaiser weights
computed from its fractional offset. Output positions come from an exact
integer-phase decomposition on the host (``_positions``, int64, no drift).

The output rows are computed in blocks of ``_BLOCK``: each row depends only
on its own taps, so blocking leaves every value as it is, and the [rows,
taps] weight, index and gather temporaries stay at a few tens of MB for any
track length (a whole 2^23-sample track at once would need several GB).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BLOCK = 1 << 16        # output rows per block


def _positions(n_out: int, in_rate: float, out_rate: float):
    """Exact integer-phase output positions (host, int64 — no drift)."""
    # reduce in/out to an integer fraction; float rates are scaled first
    # (audio rates are integers in practice; 1e6 covers e.g. 44.1 exactly)
    num = int(round(in_rate * 1_000_000))
    den = int(round(out_rate * 1_000_000))
    g = math.gcd(num, den)
    num //= g
    den //= g
    m = np.arange(n_out, dtype=np.int64) * num
    base = (m // den).astype(np.int32)
    frac = ((m % den).astype(np.float64) / den).astype(np.float32)
    return base, frac


def kernel_taps(in_rate: float, out_rate: float, taps: int = 64) -> int:
    """The kernel length used for in_rate -> out_rate: ``taps`` at the
    lower of the two rates, so scaled by in/out when downsampling (44.1 ->
    22.05 kHz takes 128)."""
    cutoff = min(1.0, float(out_rate) / float(in_rate))
    if cutoff < 1.0:
        taps = int(math.ceil(taps / cutoff / 8.0)) * 8
    return taps


def input_needed(n_out: int, in_rate: float, out_rate: float,
                 taps: int = 64) -> int:
    """Input samples that the first ``n_out`` output samples read: cutting
    the input there leaves those outputs exactly as they are."""
    base, _ = _positions(n_out, float(in_rate), float(out_rate))
    return int(base[-1]) + kernel_taps(in_rate, out_rate, taps) // 2 + 1


def resample(x: torch.Tensor, in_rate: float, out_rate: float,
             taps: int = 64, beta: float = 8.6) -> torch.Tensor:
    """Resample along axis 0 of [N] or [N, C] float32. Returns
    floor(N * out/in) samples.

    ``taps`` is the kernel length at the LOWER of the two rates; when
    downsampling it is scaled by in/out so the anti-alias transition band
    stays proportional to the output Nyquist."""
    if in_rate == out_rate:
        return x
    n_in = x.shape[0]
    n_out = int(n_in * out_rate / in_rate)
    base, frac = _positions(n_out, float(in_rate), float(out_rate))
    cutoff = min(1.0, float(out_rate) / float(in_rate))
    taps = kernel_taps(in_rate, out_rate, taps)
    half = taps // 2
    dev = x.device
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    base_t = torch.from_numpy(base).to(dev)
    frac_t = torch.from_numpy(frac).to(dev)
    k = torch.arange(-half + 1, half + 1, device=dev)              # [taps]
    kf = k.to(torch.float32)
    i0_beta = torch.special.i0(torch.tensor(beta, dtype=torch.float32,
                                            device=dev))
    y = torch.empty((n_out, x2.shape[1]), dtype=torch.float32, device=dev)
    for s in range(0, n_out, _BLOCK):
        idx = base_t[s:s + _BLOCK, None].to(torch.int64) + k[None, :]
        valid = (idx >= 0) & (idx < n_in)
        # sinc lowpass at the lower of the two Nyquists, Kaiser window
        t = kf[None, :] - frac_t[s:s + _BLOCK, None]               # [o, taps]
        w_sinc = cutoff * torch.sinc(cutoff * t)
        tw = torch.clamp(t / half, -1.0, 1.0)
        win = torch.special.i0(beta * torch.sqrt(1.0 - tw * tw)) / i0_beta
        w = torch.where(valid, w_sinc * win, 0.0)
        gathered = x2[idx.clamp(0, n_in - 1)]               # [o, taps, C]
        y[s:s + _BLOCK] = torch.einsum("ot,otc->oc", w, gathered)
    return y[:, 0] if squeeze else y
