"""Multiband compression (PyTorch port of ``ame_tpu/graph/multiband.py``).

Compat (``_crossover_compat``, ``multiband_compat``): the reference wiring
(audio_mastering_engine.py:299-309): order-4 Butterworth low (250 Hz) and
high (4 kHz) bands, a subtractive mid (mid = full − low − high, quirk Q4),
per-band int16 quantization (Q5), exact pydub compression of the three
bands in one gain-engine pass (``exact=False``: the clamp-approximation
``compressor.pydub_compress_fast`` a band), and saturating ``overlay`` adds
(Q7). The two crossover filters are two ``sosfilt`` calls (the JAX package
fuses them into one tile-conv bank). With ``chunk_len``
(chunked compat, Q6) the filters, the detectors and the gain state restart
at every chunk.

Quality (``_band_cascades_3``, ``quality_band_split``, ``_band_cascades_n``,
``quality_band_split_n``, ``multiband_quality``, ``multiband_quality_n``):
Linkwitz-Riley LR4 crossovers that sum flat, f32 throughout, the quality
compressor on all bands at once. Each band is one cascade straight off x
(the reference's tile-conv bank form), one ``sosfilt`` a band; a band of a
G-band tree has up to 2(G−1) sections, which ``sosfilt`` runs as pieces of
at most 8. The quality stages are differentiable in x and in tensor
thresholds and ratios (``models/automaster.py``): the bands' fixed
cascades then go through ``scan_iir.SosfiltFn`` on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch import config as C
from ame_tpu_torch.dsp import design
from ame_tpu_torch.ops import compressor, quantize
from ame_tpu_torch.ops.eq import _run_sos
from ame_tpu_torch.ops.scan_iir import sosfilt


def _crossover_compat(x: torch.Tensor, sample_rate: float,
                      chunk_len: int | None = None):
    low = _run_sos(design.butter_sos(4, C.MB_LOW_CROSSOVER_HZ, "lowpass",
                                     fs=sample_rate), x, chunk_len)
    high = _run_sos(design.butter_sos(4, C.MB_HIGH_CROSSOVER_HZ, "highpass",
                                      fs=sample_rate), x, chunk_len)
    mid = x - low - high  # quirk Q4: phase-imperfect subtractive crossover
    return low, mid, high


def _compress_band_fast(band_int: torch.Tensor, sample_rate: float,
                        thresh: float, ratio: float,
                        chunk_len: int | None) -> torch.Tensor:
    """``compressor.pydub_compress_fast`` on one int16-valued band, each
    chunk a fresh call when ``chunk_len`` is given."""
    if chunk_len is None:
        return compressor.pydub_compress_fast(band_int, sample_rate, thresh,
                                              ratio)
    return torch.cat([compressor.pydub_compress_fast(
        band_int[i:i + chunk_len], sample_rate, thresh, ratio)
        for i in range(0, band_int.shape[0], chunk_len)])


def multiband_compat(x: torch.Tensor, sample_rate: float, threshs,
                     ratios, exact: bool = True,
                     chunk_len: int | None = None) -> torch.Tensor:
    """x: [N, 2] int16-grid float audio. threshs / ratios: three per-band
    values (host floats or a tensor). ``exact`` False compresses each band
    with the clamp-approximation ``compressor.pydub_compress_fast``
    instead of the exact gain engine. Returns int16-grid float audio
    (value / 32768)."""
    low, mid, high = _crossover_compat(x, sample_rate, chunk_len)
    band_ints = [quantize.float_to_int16(b) for b in (low, mid, high)]
    ths = [float(threshs[g]) for g in range(3)]
    ras = [float(ratios[g]) for g in range(3)]
    if not exact:
        outs = [_compress_band_fast(band_ints[g], sample_rate, ths[g],
                                    ras[g], chunk_len) for g in range(3)]
    elif chunk_len is None:
        outs = compressor.pydub_compress_exact_multi(band_ints, sample_rate,
                                                     ths, ras)
    else:
        outs = compressor.pydub_compress_exact_multi_chunked(
            band_ints, sample_rate, ths, ras, chunk_len)
    acc = quantize.saturating_add_int16(outs[0], outs[1])
    acc = quantize.saturating_add_int16(acc, outs[2])  # quirk Q7
    return acc * (1.0 / 32768.0)


def _band_cascades_3(sample_rate: float):
    """The three band cascades of ``quality_band_split``: low = LP250, mid =
    HP250 then LP4k, high = HP250 then HP4k (2, 4 and 4 sections)."""
    lr4 = design.linkwitz_riley_sos
    lo_lp = lr4(4, C.MB_LOW_CROSSOVER_HZ, "lowpass", sample_rate)
    lo_hp = lr4(4, C.MB_LOW_CROSSOVER_HZ, "highpass", sample_rate)
    hi_hp = lr4(4, C.MB_HIGH_CROSSOVER_HZ, "highpass", sample_rate)
    hi_lp = lr4(4, C.MB_HIGH_CROSSOVER_HZ, "lowpass", sample_rate)
    return [lo_lp, np.concatenate([lo_hp, hi_lp]),
            np.concatenate([lo_hp, hi_hp])]


def quality_band_split(x: torch.Tensor, sample_rate: float):
    """Linkwitz-Riley LR4 crossover split: [N, C] -> (low, mid, high), flat
    magnitude sum (fixes Q4). Each band is one cascade off x
    (``_band_cascades_3``)."""
    return tuple(sosfilt(sos, x)[0] for sos in _band_cascades_3(sample_rate))


def _band_cascades_n(sample_rate: float, edges: tuple):
    """Per-band SOS cascades straight off x for a G = len(edges)+1 way LR4
    crossover tree (left-to-right splits): band g is LP(e_g) composed with
    the highpasses of every edge below it, plus the LR4 allpasses of every
    edge above it (phase compensation: band g never passes through the
    higher splits, whose LP + HP sum is an allpass, so without them the
    tree's sum is not flat). The top band is the pure highpass cascade.
    Band g has 2g + 2 + (G − 2 − g) sections, the top band 2(G − 1)."""
    cascades, prefix = [], []
    for i, e in enumerate(edges):
        lp = design.linkwitz_riley_sos(4, float(e), "lowpass", sample_rate)
        comp = [design.lr4_allpass_sos(float(e2), sample_rate)
                for e2 in edges[i + 1:]]
        cascades.append(np.concatenate(prefix + [lp] + comp))
        prefix = prefix + [design.linkwitz_riley_sos(4, float(e), "highpass",
                                                     sample_rate)]
    cascades.append(np.concatenate(prefix))
    return cascades


def quality_band_split_n(x: torch.Tensor, sample_rate: float, edges):
    """[N, C] -> list of G = len(edges)+1 bands (LR4 tree crossover with
    allpass phase compensation: the bands sum flat at any G), one cascade
    off x a band."""
    return [sosfilt(c, x)[0]
            for c in _band_cascades_n(sample_rate, tuple(edges))]


def multiband_quality_n(x: torch.Tensor, sample_rate: float, edges, threshs,
                        ratios, attack_ms: float = C.MB_ATTACK_MS,
                        release_ms: float = C.MB_RELEASE_MS) -> torch.Tensor:
    """G-band quality multiband compression (G = len(edges)+1); threshs /
    ratios: G per-band values. The bands recombine by a flat sum."""
    bands = quality_band_split_n(x, sample_rate, edges)
    comp = compressor.compress_quality_multi(bands, sample_rate, threshs,
                                             ratios, attack_ms, release_ms)
    out = comp[0]
    for b in comp[1:]:
        out = out + b
    return out


def multiband_quality(x: torch.Tensor, sample_rate: float, threshs, ratios,
                      attack_ms: float = C.MB_ATTACK_MS,
                      release_ms: float = C.MB_RELEASE_MS) -> torch.Tensor:
    """LR4 3-band crossover (flat sum, fixes Q4), f32 throughout (fixes
    Q5/Q7), the quality compressor on the three bands at once."""
    low, mid, high = quality_band_split(x, sample_rate)
    comp = compressor.compress_quality_multi([low, mid, high], sample_rate,
                                             threshs, ratios, attack_ms,
                                             release_ms)
    return comp[0] + comp[1] + comp[2]
