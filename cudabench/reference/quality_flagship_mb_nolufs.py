"""Reference of the ``quality_flagship_mb_nolufs`` configuration: the quality
chain of ``reference/quality.py`` with the 3-band multiband compressor
between the width and the limiter, loudness off.

numpy and scipy in float64, like its siblings; it imports nothing of the
program. The stage, as the configuration states it:

  1. split: Linkwitz-Riley LR4 crossovers at 250 Hz and 4 kHz, each LR4 a
     2nd-order Butterworth biquad applied twice, designed here from its
     analog prototype wc^2 / (s^2 + sqrt(2) wc s + wc^2) (s^2 over the same
     for the highpass) by the bilinear transform, prewarped to the
     crossover. Each band is one cascade off x: low = LP250 (2 sections),
     mid = HP250 then LP4k (4), high = HP250 then HP4k (4). The low band
     passes no 4 kHz allpass, so the three sum to within 0.05 dB of flat,
     not exactly (the program's 3-band split, likewise);
  2. level: the mean over the past 5 ms (220 frames at 44.1 kHz, clipped
     at the start) of each band's channel-mean square, in dB (floored at
     -120 dB);
  3. gain reduction: max(0, level - threshold) * (1 - 1/ratio) dB a band;
  4. release: y[n] = max(u[n], rho * y[n-1]), rho = exp(-1 / (0.050 fs));
  5. attack: a one-pole smoother at 5 ms, y[n] = (1 - a) u[n] + a y[n-1],
     a = exp(-1 / (0.005 fs)), its two coefficients rounded to float32 as
     the program's ``compressor.attack_sos`` rounds them;
  6. apply: each band times 10^(-gr/20), the bands summed flat.

``mantissa_bits`` rounds every handover the stage adds, as ``quality.py``
rounds its own: each band, the level, the gain reduction after the release
and after the attack, the gains and the sum. ``info`` receives, beside the
limiter's input peak, each band's share of the input's sounding frames
(those not digital silence) whose level is over its threshold:
``over_low``, ``over_mid``, ``over_high``.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import bilinear, lfilter, sosfilt

from cudabench.reference import quality

LOW_HZ = 250.0
HIGH_HZ = 4000.0
RMS_MS = 5.0
ATTACK_MS = 5.0
RELEASE_MS = 50.0
BANDS = ("low", "mid", "high")

# The check's limit on the widest gap, in LSB, between a master the program
# wrote and the reference's (PERF.md gives the readings it was set from).
LIMITS = {"max_lsb": 6}

BLOCK = 1 << 14           # frames a block of ``_sosfilt``
TINY = 1e-200             # filter state flushed to 0 below this


def _sosfilt(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``sosfilt`` along axis 0, in blocks of ``BLOCK`` frames whose end
    state is set to 0 where it is below ``TINY``. In digital silence a
    cascade's state decays into subnormal floats, on which scipy's loop
    runs ~30 times slower; the flush moves no sample by more than ~1e-199,
    and ends each silent stretch in exact zeros."""
    zi = np.zeros((sos.shape[0], 2) + x.shape[1:])
    out = np.empty_like(x)
    for i in range(0, x.shape[0], BLOCK):
        out[i:i + BLOCK], zi = sosfilt(sos, x[i:i + BLOCK], axis=0, zi=zi)
        zi[np.abs(zi) < TINY] = 0.0
    return out


def butter2(fc: float, fs: float, kind: str) -> np.ndarray:
    """The 2nd-order Butterworth low- or highpass at ``fc`` as one SOS row
    [b0, b1, b2, 1, a1, a2]: bilinear transform, prewarped to ``fc``."""
    wc = 2.0 * fs * math.tan(math.pi * fc / fs)
    num = [0.0, 0.0, wc * wc] if kind == "low" else [1.0, 0.0, 0.0]
    b, a = bilinear(num, [1.0, math.sqrt(2.0) * wc, wc * wc], fs)
    return np.concatenate([b, a])


def lr4(fc: float, fs: float, kind: str) -> np.ndarray:
    """LR4: the Butterworth biquad twice, [2, 6]."""
    return np.stack([butter2(fc, fs, kind)] * 2)


def band_cascades(fs: float) -> list[np.ndarray]:
    hp_low = lr4(LOW_HZ, fs, "high")
    return [lr4(LOW_HZ, fs, "low"),
            np.concatenate([hp_low, lr4(HIGH_HZ, fs, "low")]),
            np.concatenate([hp_low, lr4(HIGH_HZ, fs, "high")])]


def split(x: np.ndarray, fs: float) -> list[np.ndarray]:
    """[N, 2] -> the three bands, each one cascade off x."""
    return [_sosfilt(c, x) for c in band_cascades(fs)]


def level_db(bands, fs: float) -> np.ndarray:
    """[N, 3]: each band's past-5 ms mean of its channel-mean square, dB."""
    w = max(int(RMS_MS * fs / 1000.0), 1)
    return np.stack([10.0 * np.log10(np.maximum(
        quality._mean_past(np.mean(b * b, axis=1), w), 1e-12))
        for b in bands], axis=1)


def release(gr: np.ndarray, fs: float) -> np.ndarray:
    rho = math.exp(-1.0 / (RELEASE_MS * fs / 1000.0))
    return np.stack([quality._release(gr[:, g], rho)
                     for g in range(gr.shape[1])], axis=1)


def attack(gr: np.ndarray, fs: float) -> np.ndarray:
    a = math.exp(-1.0 / (ATTACK_MS * fs / 1000.0))
    b0, a1 = float(np.float32(1.0 - a)), float(np.float32(-a))
    return lfilter([b0], [1.0, a1], gr, axis=0)


def multiband(x: np.ndarray, fs: float, settings: dict, r, info: dict,
              sounding: np.ndarray) -> np.ndarray:
    """The 3-band stage on [N, 2]; ``r`` rounds each handover; the shares
    over threshold are of the frames where ``sounding``."""
    th = np.array([float(settings[f"{b}_thresh"]) for b in BANDS])
    ra = np.array([float(settings[f"{b}_ratio"]) for b in BANDS])
    bands = [r(b) for b in split(x, fs)]
    level = r(level_db(bands, fs))
    over = (level > th)[sounding]
    for g, b in enumerate(BANDS):
        info[f"over_{b}"] = float(over[:, g].mean()) if over.size else 0.0
    gr = np.maximum(level - th, 0.0) * (1.0 - 1.0 / ra)
    gr = r(release(gr, fs))
    gr = r(attack(gr, fs))
    gains = r(10.0 ** (-gr / 20.0))
    y = bands[0] * gains[:, 0:1]
    for g in range(1, len(bands)):
        y = y + bands[g] * gains[:, g:g + 1]
    return r(y)


def master(pcm: np.ndarray, fs: float, settings: dict,
           mantissa_bits: int | None = None,
           info: dict | None = None) -> np.ndarray:
    """int16 [N, 2] in, int16 [N, 2] out: ``quality.py``'s pre-stage (drive,
    analog shelves, EQ, width), the multiband stage, ``quality.limiter``
    and the 16-bit output."""
    info = {} if info is None else info
    if (settings.get("mode", "quality") != "quality"
            or not settings.get("multiband", False)
            or settings.get("mb_edges") is not None
            or settings.get("lufs") is not None):
        raise ValueError("this reference covers the quality chain with the "
                         "3-band multiband stage and loudness off only")

    def r(v):
        return quality.round_mantissa(v, mantissa_bits)

    x = r(pcm.astype(np.float64) / 32768.0)
    percent = float(settings.get("analog_character", 0.0))
    if percent > 0:
        x = r(np.tanh(x * (1.0 + percent / 100.0 * 0.5)))
        x = r(_sosfilt(quality.analog_sos(fs, percent), x))
    x = r(_sosfilt(quality.eq_sos(fs, settings), x))
    width = float(settings.get("width", 1.0))
    if width != 1.0:
        mid = (x[:, 0] + x[:, 1]) * 0.5
        side = (x[:, 0] - x[:, 1]) * 0.5 * width
        x = r(np.stack([mid + side, mid - side], axis=1))
    x = multiband(x, fs, settings, r, info, np.any(pcm != 0, axis=1))
    info["limiter_in_peak"] = float(np.abs(x).max())
    y = r(quality.limiter(x, fs))
    return np.trunc(np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
