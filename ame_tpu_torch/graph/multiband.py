"""3-band multiband compression, compat mode (PyTorch port of
``ame_tpu/graph/multiband.py``: ``_crossover_compat`` unchunked and
``multiband_compat`` with ``exact=True``, ``chunk_len=None``).

The reference wiring (audio_mastering_engine.py:299-309): order-4
Butterworth low (250 Hz) and high (4 kHz) bands, a subtractive mid
(mid = full − low − high, quirk Q4), per-band int16 quantization (Q5), exact
pydub compression of the three bands in one gain-engine pass, and saturating
``overlay`` adds (Q7). The two crossover filters are two ``sosfilt`` calls
(the JAX package fuses them into one tile-conv bank).

Quality multiband, G-band edges and chunked compat are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from ame_tpu_torch import config as C
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import compressor, quantize
from ame_tpu_torch.ops.scan_iir import sosfilt


def _crossover_compat(x: torch.Tensor, sample_rate: float):
    low, _ = sosfilt(design.butter_sos(4, C.MB_LOW_CROSSOVER_HZ, "lowpass",
                                       fs=sample_rate), x)
    high, _ = sosfilt(design.butter_sos(4, C.MB_HIGH_CROSSOVER_HZ,
                                        "highpass", fs=sample_rate), x)
    mid = x - low - high  # quirk Q4: phase-imperfect subtractive crossover
    return low, mid, high


def multiband_compat(x: torch.Tensor, sample_rate: float, threshs,
                     ratios) -> torch.Tensor:
    """x: [N, 2] int16-grid float audio. threshs / ratios: three per-band
    values (host floats or a tensor). Returns int16-grid float audio
    (value / 32768)."""
    low, mid, high = _crossover_compat(x, sample_rate)
    band_ints = [quantize.float_to_int16(b) for b in (low, mid, high)]
    outs = compressor.pydub_compress_exact_multi(
        band_ints, sample_rate, [float(threshs[g]) for g in range(3)],
        [float(ratios[g]) for g in range(3)])
    acc = quantize.saturating_add_int16(outs[0], outs[1])
    acc = quantize.saturating_add_int16(acc, outs[2])  # quirk Q7
    return acc * (1.0 / 32768.0)
