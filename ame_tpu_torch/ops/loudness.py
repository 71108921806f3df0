"""EBU R128 / ITU-R BS.1770 loudness measurement and two-pass normalization
(PyTorch port).

Port of ``ame_tpu/ops/loudness.py``: ``_gating_block_powers``,
``_integrated_gate``, ``_lra_gate``, ``_measure_jit`` (here ``_measure``,
with its ``dynamic_domain`` flag), ``gated_stats_from_hops``,
``_tp_filterbank``, ``_tp_tile_matrix``, ``true_peak``, ``integrated_lufs``,
``measure`` and ``normalize_two_pass``. Everything stays on the input's device; results are
0-d tensors, so a master needs no host round trip until its info is read.

  * K-filter: the 2-section cascade through ``scan_iir.sosfilt``.
  * block energies: 100 ms hop sums, each 400 ms block = sum of 4 hops.
  * integrated: -70 LUFS absolute gate, -10 LU relative gate.
  * LRA: 3 s blocks at a 1 s hop, -20 LU relative gate, P10..P95 at
    round-nearest order statistics (libebur128 semantics).
  * true peak: 4x polyphase oversampling as one overlapped-tile matrix
    product. The reference contracts bf16 operands with f32 accumulation on
    purpose (<= ~0.02 dB on the intersample excess); this port reproduces
    that exactly: the tile matrix and signal tiles are rounded to bf16, then
    upcast, and the product runs in f32 (a bf16 matmul would also round the
    output).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops.scan_iir import sosfilt


# ---------------------------------------------------------------------------
# Block energies and gates
# ---------------------------------------------------------------------------

def _gating_block_powers(y: torch.Tensor, sample_rate: float, block_s: float,
                         hop_s: float, n_valid: int | None = None):
    """Mean-square power per gating block (sum over channels of per-channel
    mean square). y: [N, C] K-weighted audio. Returns ([n_blocks] powers,
    [n_blocks] validity mask); blocks ending past ``n_valid`` are masked."""
    n = y.shape[0]
    hop = int(round(hop_s * sample_rate))
    steps = int(round(block_s / hop_s))  # sub-hops per block (4 or 30)
    n_hops = n // hop
    if n_hops < steps:
        z = y.new_zeros((0,))
        return z, z.bool()
    sq = torch.sum(y * y, dim=1)
    hop_sums = torch.sum(sq[: n_hops * hop].reshape(n_hops, hop), dim=1)
    n_blocks = n_hops - steps + 1         # block j covers hops [j, j+steps)
    csum = torch.cat([hop_sums.new_zeros((1,)), torch.cumsum(hop_sums, 0)])
    block_sums = csum[steps:steps + n_blocks] - csum[:n_blocks]
    powers = block_sums / (hop * steps)
    if n_valid is None:
        valid = torch.ones((n_blocks,), dtype=torch.bool, device=y.device)
    else:
        ends = (torch.arange(n_blocks, device=y.device) + steps) * hop
        valid = ends <= n_valid
    return powers, valid


def _power_to_lufs(p: torch.Tensor) -> torch.Tensor:
    return -0.691 + 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def _masked_mean(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (torch.sum(torch.where(mask, p, torch.zeros_like(p)))
            / torch.clamp(torch.sum(mask), min=1))


def _integrated_gate(p_m: torch.Tensor, v_m: torch.Tensor):
    """BS.1770 two-stage gate over 400 ms block powers -> (integrated LUFS,
    relative threshold)."""
    l_m = _power_to_lufs(p_m)
    abs_mask = (l_m > -70.0) & v_m
    any_abs = torch.any(abs_mask)
    rel_thresh = torch.where(any_abs,
                             _power_to_lufs(_masked_mean(p_m, abs_mask)) - 10.0,
                             torch.full((), -70.0, device=p_m.device))
    gate = abs_mask & (l_m > rel_thresh)
    integrated = torch.where(any_abs & torch.any(gate),
                             _power_to_lufs(_masked_mean(p_m, gate)),
                             torch.full((), -float("inf"), device=p_m.device))
    return integrated, rel_thresh


def _lra_gate(p_s: torch.Tensor, v_s: torch.Tensor) -> torch.Tensor:
    """LRA from 3 s block powers: -20 LU relative gate, P10..P95 at
    round-nearest order statistics of the gated blocks."""
    if p_s.shape[0] == 0:
        return p_s.new_zeros(())
    l_s = _power_to_lufs(p_s)
    abs_s = (l_s > -70.0) & v_s
    rel_s = _power_to_lufs(_masked_mean(p_s, abs_s)) - 20.0
    gate_s = abs_s & (l_s > rel_s)
    n_g = torch.sum(gate_s)
    l_sorted = torch.sort(torch.where(gate_s, l_s,
                                      torch.full_like(l_s, float("inf"))))[0]
    top = torch.clamp(n_g - 1, min=0)

    def _pct(q):
        pos = q * (n_g - 1).to(l_sorted.dtype)
        idx = torch.minimum(torch.clamp(torch.round(pos).long(), min=0), top)
        return l_sorted[idx]

    return torch.where(n_g > 0, _pct(0.95) - _pct(0.10),
                       l_sorted.new_zeros(()))


def _measure(x: torch.Tensor, sample_rate: float, n_valid: int | None = None,
             dynamic_domain: bool = False):
    """(integrated, lra, rel_thresh) of [N, C] audio. ``dynamic_domain``
    measures as ffmpeg's dynamic-mode loudnorm does, with the corrected
    K-weighting of ``design.k_weighting_dynamic_sos``."""
    sos = (design.k_weighting_dynamic_sos(sample_rate) if dynamic_domain
           else design.k_weighting_sos(sample_rate))
    y, _ = sosfilt(sos, x)
    p_m, v_m = _gating_block_powers(y, sample_rate, 0.400, 0.100, n_valid)
    integrated, rel_thresh = _integrated_gate(p_m, v_m)
    p_s, v_s = _gating_block_powers(y, sample_rate, 3.000, 1.000, n_valid)
    return integrated, _lra_gate(p_s, v_s), rel_thresh


def gated_stats_from_hops(hop_sums: torch.Tensor, hop: int,
                          n_valid: int | None = None):
    """(integrated, lra, rel_thresh) from 100 ms hop ENERGIES [H] (K-weighted
    squares summed over channels) — the hop-domain twin of ``_measure``.
    ``n_valid`` masks gating blocks that end past the true track end."""
    H = hop_sums.shape[0]
    nv = H * hop if n_valid is None else int(n_valid)
    dev = hop_sums.device
    csum = torch.cat([hop_sums.new_zeros((1,)), torch.cumsum(hop_sums, 0)])
    nb_m = H - 4 + 1
    p_m = (csum[4:4 + nb_m] - csum[:nb_m]) / (hop * 4)
    v_m = (torch.arange(nb_m, device=dev) + 4) * hop <= nv
    integrated, rel_thresh = _integrated_gate(p_m, v_m)
    hps = 10                                # hops per second
    n_sec = H // hps
    if n_sec >= 3:
        hs_s = torch.sum(hop_sums[: n_sec * hps].reshape(n_sec, hps), dim=1)
        csum_s = torch.cat([hs_s.new_zeros((1,)), torch.cumsum(hs_s, 0)])
        nb_s = n_sec - 3 + 1
        p_s = (csum_s[3:3 + nb_s] - csum_s[:nb_s]) / (hop * hps * 3)
        v_s = (torch.arange(nb_s, device=dev) + 3) * (hop * hps) <= nv
        lra = _lra_gate(p_s, v_s)
    else:
        lra = hop_sums.new_zeros(())
    return integrated, lra, rel_thresh


# ---------------------------------------------------------------------------
# True peak (4x polyphase oversampling)
# ---------------------------------------------------------------------------

_TP_FACTOR = 4
_TP_TAPS_PER_PHASE = 32
_TP_LB = 128  # tile length for the matmul formulation


def _tp_filterbank() -> np.ndarray:
    """[factor, taps] polyphase interpolation bank: windowed-sinc lowpass at
    the original Nyquist, Kaiser beta 5, gain preserved per phase, centered
    on an integer tap (phase 0 is a pure passthrough)."""
    factor, tpp = _TP_FACTOR, _TP_TAPS_PER_PHASE
    taps = factor * tpp
    center = taps // 2
    nidx = np.arange(taps) - center
    h = np.sinc(nidx / factor) * np.kaiser(taps + 1, 5.0)[:taps]
    h = h / np.sum(h) * factor
    return h.reshape(tpp, factor).T.copy()  # [factor, tpp]


def _tp_tile_matrix() -> np.ndarray:
    """[factor*LB, 2*LB] matrix computing all ``factor`` interpolation phases
    of one 128-sample tile from (previous tile | current tile) columns:

        out[p*LB + t] = sum_tau bank[p, tau] * xcat[LB + t - tau]
    """
    bank = _tp_filterbank()
    factor, tpp = bank.shape
    M = np.zeros((factor * _TP_LB, 2 * _TP_LB))
    for p in range(factor):
        for t in range(_TP_LB):
            for tau in range(tpp):
                M[p * _TP_LB + t, _TP_LB + t - tau] = bank[p, tau]
    return M


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back. Differentiable: its backward rounds the
    cotangent to bf16 too, as ``ame_tpu``'s ``astype`` pair does, so a
    true-peak gradient agrees with the reference's to bf16's precision."""
    return t.to(torch.bfloat16).to(torch.float32)


@functools.lru_cache(maxsize=8)
def _tp_matrix(device: torch.device) -> torch.Tensor:
    """The bf16-rounded tile matrix (held as f32), built once per device."""
    return _bf16_round(torch.from_numpy(_tp_tile_matrix()).float()).to(device)


def true_peak(x: torch.Tensor) -> torch.Tensor:
    """Linear-scale true peak of [N, C] audio (BS.1770 4x oversampling)."""
    n, c = x.shape
    Lb = _TP_LB
    nb = -(-n // Lb)
    M = _tp_matrix(x.device)
    # one leading zero tile (zero FIR history) + tail padding to a tile
    xp = F.pad(x, (0, 0, Lb, nb * Lb - n))
    xt = xp.reshape(nb + 1, Lb, c)
    xcat = _bf16_round(torch.cat([xt[:-1], xt[1:]], dim=1))   # [nb, 2LB, C]
    out = torch.einsum("vu,buc->bvc", M, xcat)                # f32 products
    # mask interpolants of the zero tail padding
    t_in_tile = torch.arange(M.shape[0], device=x.device) % Lb
    sample_n = (torch.arange(nb, device=x.device)[:, None] * Lb
                + t_in_tile[None, :])
    valid = (sample_n < n)[:, :, None]
    peak_os = torch.amax(torch.where(valid, out.abs(), torch.zeros_like(out)))
    return torch.maximum(peak_os, torch.amax(x.abs()))


def true_peak_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(true_peak(x), min=1e-12))


# ---------------------------------------------------------------------------
# Public measurement API
# ---------------------------------------------------------------------------

def integrated_lufs(x: torch.Tensor, sample_rate: float,
                    n_valid: int | None = None) -> torch.Tensor:
    """Gated integrated loudness of [N, C] (or [N]) audio, in LUFS."""
    if x.ndim == 1:
        x = x[:, None]
    return _measure(x, float(sample_rate), n_valid)[0]


def measure(x: torch.Tensor, sample_rate: float,
            n_valid: int | None = None, dynamic_domain: bool = False) -> dict:
    """Integrated loudness, LRA, 4x true peak (dBTP) and the integrated
    measurement's relative gating threshold, as 0-d tensors."""
    if x.ndim == 1:
        x = x[:, None]
    integrated, lra, rel_thresh = _measure(x, float(sample_rate), n_valid,
                                           dynamic_domain)
    return {"input_i": integrated, "input_lra": lra,
            "input_tp": true_peak_db(x), "input_thresh": rel_thresh}


# ---------------------------------------------------------------------------
# Two-pass normalization
# ---------------------------------------------------------------------------

def normalize_two_pass(x: torch.Tensor, sample_rate: float,
                       target_lufs: float = -14.0,
                       n_valid: int | None = None):
    """Measure, then apply one linear gain to reach ``target_lufs`` — the
    quality chain's normalizer (the reference's ``protect_tp`` cap, which no
    caller sets, is not ported). Silent input (measured -inf) passes through
    unchanged (quirk Q9).

    Returns (y, info dict of 0-d tensors)."""
    if x.ndim == 1:
        x = x[:, None]
    stats = measure(x, sample_rate, n_valid)
    silent = ~torch.isfinite(stats["input_i"])
    offset = target_lufs - stats["input_i"]
    gain_db = torch.where(silent, torch.zeros_like(offset), offset)
    y = x * 10.0 ** (gain_db / 20.0)
    return y, {**stats, "gain_db": gain_db,
               "output_i": stats["input_i"] + gain_db,
               "linear_mode": torch.ones((), device=x.device)}
