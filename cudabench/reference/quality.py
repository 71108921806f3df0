"""Plain float64 reference of the quality mastering chain (no multiband),
shared by the quality configurations' references.

numpy and scipy only: it imports nothing of the program, designs every
filter itself and recomputes the master from the input file's samples.
The chain is the product chain of the reference engine's stage order
(audio_mastering_engine.py:185-229), in its quality form:

  1. analog character: tanh(x * (1 + percent/200)), then an RBJ low shelf
     at 120 Hz (+percent/100 dB) and an RBJ high shelf at 12 kHz
     (+1.5 * percent/100 dB), both Q 0.7071;
  2. EQ: RBJ low shelf 250 Hz (bass, Q 0.7071), peaking 1 kHz (-mid_cut,
     Q 1.41), peaking 4 kHz (presence, Q 1.41), high shelf 8 kHz (treble,
     Q 0.7071), every section present even at 0 dB;
  3. width: mid/side with side * width, no clip;
  4. loudness (where ``lufs`` is not None): BS.1770 integrated loudness
     (K-weighting, 400 ms blocks at a 100 ms hop, -70 LUFS absolute and
     -10 LU relative gates) and one gain to the target; a silent track
     keeps unit gain;
  5. limiter, ceiling 0.98, channel-linked: the target gain
     min(1, 0.98 / peak), its minimum over the next 220 samples (5 ms,
     clipped at the end), its mean over the past 220 (clipped at the
     start), and a release 1 - g[n] = max(1 - g_r[n], rho * (1 - g[n-1]))
     with rho = exp(-1 / 2205) (50 ms);
  6. 16-bit output: trunc(clip(y, -1, 1) * 32767).

``mantissa_bits`` rounds every signal handed from one stage to the next
(the decoded input, the drive, each cascade's output, the width, the gain,
the limiter) to that many mantissa bits of float32, round to nearest even:
10 is TF32, 7 bfloat16. It is the control of the check and never the
reference itself.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import bilinear, sosfilt

SHELF_Q = 0.7071
PEAK_Q = 1.41
CEILING = 0.98
ATTACK_MS = 5.0
RELEASE_MS = 50.0


def round_mantissa(x: np.ndarray, bits: int | None) -> np.ndarray:
    """x rounded to float32 with ``bits`` mantissa bits (nearest, ties to
    even), returned as float64; ``bits=None`` returns x."""
    if bits is None:
        return x
    drop = 23 - bits
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    u = (u + half + ((u >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


# --- filter designs (RBJ audio EQ cookbook) ---------------------------------

def _rbj(kind: str, f0: float, fs: float, gain_db: float, q: float):
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * f0 / fs
    c, alpha = math.cos(w0), math.sin(w0) / (2.0 * q)
    if kind == "peak":
        b = [1 + alpha * A, -2 * c, 1 - alpha * A]
        a = [1 + alpha / A, -2 * c, 1 - alpha / A]
    else:
        s = 2.0 * math.sqrt(A) * alpha
        sign = 1.0 if kind == "low" else -1.0
        b = [A * ((A + 1) - sign * (A - 1) * c + s),
             sign * 2 * A * ((A - 1) - sign * (A + 1) * c),
             A * ((A + 1) - sign * (A - 1) * c - s)]
        a = [(A + 1) + sign * (A - 1) * c + s,
             -sign * 2 * ((A - 1) + sign * (A + 1) * c),
             (A + 1) + sign * (A - 1) * c - s]
    return np.array(b + a) / a[0]


def analog_sos(fs: float, percent: float) -> np.ndarray:
    f = percent / 100.0
    return np.stack([_rbj("low", 120.0, fs, f * 1.0, SHELF_Q),
                     _rbj("high", 12000.0, fs, f * 1.5, SHELF_Q)])


def eq_sos(fs: float, s: dict) -> np.ndarray:
    return np.stack([
        _rbj("low", 250.0, fs, s.get("bass_boost", 0.0), SHELF_Q),
        _rbj("peak", 1000.0, fs, -s.get("mid_cut", 0.0), PEAK_Q),
        _rbj("peak", 4000.0, fs, s.get("presence_boost", 0.0), PEAK_Q),
        _rbj("high", 8000.0, fs, s.get("treble_boost", 0.0), SHELF_Q),
    ])


def k_weighting_sos(fs: float) -> np.ndarray:
    """BS.1770 K-weighting at ``fs`` (frozen copy of
    ``tests/oracles.k_weighting_sos``): the analog prototypes recovered
    from the spec's 48 kHz table, prewarped and bilinear-transformed."""
    f0, gain_db, q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    vb_exp = 0.4996667741545416
    fhp, qhp = 38.13547087602444, 0.5003270373238773
    wc = 2.0 * fs * np.tan(np.pi * f0 / fs)
    vh = 10.0 ** (gain_db / 20.0)
    vb = vh ** vb_exp
    b1, a1 = bilinear([vh, vb * wc / q, wc * wc],
                      [1.0, wc / q, wc * wc], fs)
    wh = 2.0 * fs * np.tan(np.pi * fhp / fs)
    b2, a2 = bilinear([1.0, 0.0, 0.0], [1.0, wh / qhp, wh * wh], fs)
    b2 = b2 / b2[0]
    return np.array([np.concatenate([b1, a1]), np.concatenate([b2, a2])])


# --- stages -----------------------------------------------------------------

def integrated_lufs(x: np.ndarray, fs: float) -> float:
    y = sosfilt(k_weighting_sos(fs), x, axis=0)
    hop = int(round(0.1 * fs))
    n_hops = y.shape[0] // hop
    if n_hops < 4:
        return -math.inf
    hops = np.sum((y[:n_hops * hop] ** 2).sum(axis=1).reshape(n_hops, hop),
                  axis=1)
    power = np.convolve(hops, np.ones(4), mode="valid") / (4 * hop)
    loud = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))
    gate = loud > -70.0
    if not gate.any():
        return -math.inf
    rel = -0.691 + 10.0 * math.log10(power[gate].mean()) - 10.0
    gate &= loud > rel
    if not gate.any():
        return -math.inf
    return -0.691 + 10.0 * math.log10(power[gate].mean())


def _min_ahead(g: np.ndarray, w: int) -> np.ndarray:
    """out[n] = min(g[n .. n+w-1]), the window clipped at the end: the
    suffix minimum of n's block of w beside the prefix minimum that ends
    at n+w-1."""
    n = len(g)
    nb = -(-(n + w - 1) // w)
    ext = np.concatenate([g, np.full(nb * w - n, np.inf)]).reshape(nb, w)
    pre = np.minimum.accumulate(ext, axis=1).reshape(-1)
    suf = np.minimum.accumulate(ext[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    return np.minimum(suf[:n], pre[w - 1:n + w - 1])


def _mean_past(g: np.ndarray, w: int) -> np.ndarray:
    """out[n] = mean(g[max(0, n-w+1) .. n])."""
    c = np.concatenate([[0.0], np.cumsum(g)])
    idx = np.arange(1, len(g) + 1)
    lo = np.maximum(idx - w, 0)
    return (c[idx] - c[lo]) / (idx - lo)


def _release(u: np.ndarray, rho: float, block: int = 4096) -> np.ndarray:
    """s[n] = max(u[n], rho * s[n-1]), s[-1] = 0, u >= 0, in blocks: inside
    a block s = rho^j * cummax(u * rho^-j), beside the decayed carry."""
    n = len(u)
    nb = -(-n // block)
    up = np.concatenate([u, np.zeros(nb * block - n)]).reshape(nb, block)
    j = np.arange(block)
    local = np.maximum.accumulate(up * rho ** -j, axis=1) * rho ** j
    out = np.empty_like(up)
    carry = 0.0
    decay = rho ** (j + 1)
    for b in range(nb):
        out[b] = np.maximum(local[b], carry * decay)
        carry = out[b, -1]
    return out.reshape(-1)[:n]


def limiter(x: np.ndarray, fs: float) -> np.ndarray:
    attack = max(int(ATTACK_MS * fs / 1000.0), 1)
    rho = math.exp(-1.0 / (RELEASE_MS * fs / 1000.0))
    peak = np.abs(x).max(axis=1)
    g_t = np.minimum(CEILING / np.maximum(peak, 1e-9), 1.0)
    g_r = _mean_past(_min_ahead(g_t, attack), attack)
    gain = 1.0 - _release(1.0 - g_r, rho)
    return x * gain[:, None]


def master(pcm: np.ndarray, fs: float, settings: dict,
           mantissa_bits: int | None = None,
           info: dict | None = None) -> np.ndarray:
    """int16 [N, 2] in, int16 [N, 2] out: the quality chain of ``settings``
    (quality mode, no multiband). ``info``, where given, receives the
    measured loudness, the gain and the peak the limiter saw."""
    info = {} if info is None else info
    if settings.get("mode", "quality") != "quality" or settings.get(
            "multiband", False) or settings.get("mb_edges") is not None:
        raise ValueError("this reference covers the quality chain without "
                         "multiband only")

    def r(v):
        return round_mantissa(v, mantissa_bits)

    x = r(pcm.astype(np.float64) / 32768.0)
    percent = float(settings.get("analog_character", 0.0))
    if percent > 0:
        x = r(np.tanh(x * (1.0 + percent / 100.0 * 0.5)))
        x = r(sosfilt(analog_sos(fs, percent), x, axis=0))
    x = r(sosfilt(eq_sos(fs, settings), x, axis=0))
    width = float(settings.get("width", 1.0))
    if width != 1.0:
        mid = (x[:, 0] + x[:, 1]) * 0.5
        side = (x[:, 0] - x[:, 1]) * 0.5 * width
        x = r(np.stack([mid + side, mid - side], axis=1))
    target = settings.get("lufs", -14.0)
    if target is not None:
        loud = integrated_lufs(x, fs)
        gain_db = target - loud if math.isfinite(loud) else 0.0
        info.update(input_i=loud, gain_db=gain_db)
        x = r(x * 10.0 ** (gain_db / 20.0))
    info["limiter_in_peak"] = float(np.abs(x).max())
    y = r(limiter(x, fs))
    return np.trunc(np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
