"""OUT-OF-FAMILY synthetic corpus for mood-model validation.

The port's own copy of ``ame_tpu/models/oof_corpus.py``: the same numpy
generator, so the same rng gives the same tracks bit for bit; it writes
through ``ame_tpu_torch.io.wav``.

`models/synth_corpus.py` (the TRAINING family) builds tracks from additive
sine/saw tones with attack/exp-decay envelopes, gaussian noise floors, and
metronomic event grids. Round-2 verdict: evaluating on fresh seeds of the
SAME generator proves the model learned the generator, not the mood
classes. This module is the independent second family used ONLY for
validation (tests/test_mood_model.py) — same four semantic classes, same
underlying axes (tempo / register / mode / distortion / density, the axes
the reference's tagger discriminates — its ai_tagger.py:69-73),
but disjoint synthesis machinery:

  * Karplus-Strong plucked strings (physical model: noise burst through a
    damped delay loop) instead of additive oscillators,
  * 2-operator FM (e-piano / bell / dark-pad patches) for sustained chords,
  * percussive noise bursts (kick = pitch-swept sine, hat = high-passed
    noise) on the fast classes,
  * swung / humanized event timing instead of a jittered metronome,
  * vinyl-crackle impulse noise + pink-ish background instead of white
    gaussian,
  * FFT tilt shaping with per-class spectral slopes distinct from the
    training family's single 900 Hz Sad rolloff.

Usage:
    python -m ame_tpu_torch.models.oof_corpus <out_root> [--per-class N] [--seed S]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SR = 22050

_A4 = 440.0


def _hz(semi: float) -> float:
    return _A4 * 2.0 ** (semi / 12.0)


_MAJOR9 = (0, 4, 7, 14)
_MINOR = (0, 3, 7, 10)
_POWER = (0, 7, 12)
_TRITONE = (0, 6, 12)


def _pluck(freq: float, n: int, rng, damp: float = 0.996,
           bright: float = 1.0) -> np.ndarray:
    """Karplus-Strong: noise burst through a damped averaging delay loop,
    iterated block-wise (one period per numpy op)."""
    p = max(int(round(SR / freq)), 2)
    buf = rng.uniform(-1, 1, p) * bright
    out = np.empty(n + p)
    out[:p] = buf
    i = p
    while i < n + p:
        m = min(p, n + p - i)
        prev = out[i - p: i - p + m]
        prev2 = np.concatenate([[out[i - p - 1]], prev[:-1]]) if i > p \
            else np.concatenate([[prev[0]], prev[:-1]])
        out[i: i + m] = 0.5 * damp * (prev + prev2)[:m]
        i += m
    return out[:n]


def _fm(freq: float, n: int, ratio: float, index: float,
        decay_s: float) -> np.ndarray:
    """2-operator FM with an index envelope (brightness decays with time)."""
    t = np.arange(n) / SR
    idx_env = index * np.exp(-t / max(decay_s, 1e-3))
    mod = np.sin(2 * np.pi * freq * ratio * t)
    return np.sin(2 * np.pi * freq * t + idx_env * mod)


def _adsr(n: int, a: float, d: float, s: float, r: float) -> np.ndarray:
    """ADSR envelope (the training family only has attack+exp-decay)."""
    na, nd, nr = (max(int(x * SR), 1) for x in (a, d, r))
    ns = max(n - na - nd - nr, 0)
    env = np.concatenate([
        np.linspace(0, 1, na),
        np.linspace(1, s, nd),
        np.full(ns, s),
        np.linspace(s, 0, nr)])
    return env[:n] if len(env) >= n else np.pad(env, (0, n - len(env)))


def _kick(n: int) -> np.ndarray:
    t = np.arange(n) / SR
    sweep = 120.0 * np.exp(-t * 18.0) + 40.0
    return np.sin(2 * np.pi * np.cumsum(sweep) / SR) * np.exp(-t * 14.0)


def _hat(n: int, rng) -> np.ndarray:
    x = rng.uniform(-1, 1, n) * np.exp(-np.arange(n) / (0.02 * SR))
    return np.diff(x, prepend=0.0)  # first difference ~ highpass


def _crackle(n: int, rng, density: float, amp: float) -> np.ndarray:
    """Vinyl-style impulse noise + pink-ish bed (cumsum-filtered white)."""
    imp = np.zeros(n)
    k = rng.integers(0, n, int(density * n / SR))
    imp[k] = rng.uniform(-1, 1, len(k))
    bed = np.cumsum(rng.normal(0, 1, n))
    bed -= np.linspace(bed[0], bed[-1], n)
    bed /= max(np.abs(bed).max(), 1e-9)
    return amp * (imp + 0.5 * bed)


def _tilt(y: np.ndarray, corner_hz: float, slope: float) -> np.ndarray:
    """FFT magnitude tilt: attenuate above corner by (f/corner)^-slope."""
    spec = np.fft.rfft(y)
    f = np.fft.rfftfreq(len(y), 1.0 / SR)
    g = 1.0 / (1.0 + (f / corner_hz) ** slope)
    return np.fft.irfft(spec * g, len(y))


def synth_track_oof(cls: str, rng: np.random.Generator,
                    seconds: float = 30.0) -> np.ndarray:
    """One out-of-family labeled track as [N, 2] float32."""
    n = int(seconds * SR)
    y = np.zeros(n)

    if cls == "Angry/Anxious":
        bpm = rng.uniform(148, 188)
        step = 60.0 / bpm / 2.0
        pos, i = 0.0, 0
        while pos < seconds - 0.3:
            start = int(pos * SR)
            root = rng.uniform(-12, 0)
            chord = _POWER if i % 3 else _TRITONE
            ln = int(0.22 * SR)
            seg = sum(_pluck(_hz(root + s), ln, rng, damp=0.999,
                             bright=1.5) for s in chord)
            seg = np.tanh(seg * rng.uniform(4, 7))        # hard drive
            end = min(start + ln, n)
            y[start:end] += seg[:end - start]
            if i % 2 == 0:
                kl = int(0.12 * SR)
                ke = min(start + kl, n)
                y[start:ke] += 1.2 * _kick(kl)[:ke - start]
            pos += step * rng.uniform(0.9, 1.1)           # rushed feel
            i += 1
        y += _crackle(n, rng, density=40, amp=0.05)
        gain = 0.9
    elif cls == "Calm/Content":
        bpm = rng.uniform(55, 75)
        step = 60.0 / bpm * 2.0
        pos, i = 0.0, 0
        while pos < seconds - 3.0:
            start = int(pos * SR)
            root = rng.uniform(-16, -6)
            ln = int(3.0 * SR)
            seg = sum(_fm(_hz(root + s), ln, ratio=2.0,
                          index=rng.uniform(1.0, 2.0), decay_s=1.2)
                      for s in _MAJOR9) / len(_MAJOR9)
            seg *= _adsr(ln, 0.3, 0.8, 0.55, 1.2)
            end = min(start + ln, n)
            y[start:end] += seg[:end - start]
            pos += step * rng.uniform(0.98, 1.02)
            i += 1
        y += _crackle(n, rng, density=2, amp=0.004)
        gain = 0.35
    elif cls == "Happy/Excited":
        bpm = rng.uniform(120, 158)
        eighth = 60.0 / bpm / 2.0
        pos, i = 0.0, 0
        while pos < seconds - 0.4:
            start = int(pos * SR)
            root = rng.uniform(2, 12)
            note = _MAJOR9[i % len(_MAJOR9)]
            ln = int(0.35 * SR)
            seg = _pluck(_hz(root + note), ln, rng, damp=0.994, bright=1.0)
            end = min(start + ln, n)
            y[start:end] += seg[:end - start]
            if i % 2 == 1:
                hl = int(0.05 * SR)
                he = min(start + hl, n)
                y[start:he] += 0.25 * _hat(hl, rng)[:he - start]
            swing = 1.3 if i % 2 == 0 else 0.7            # swung eighths
            pos += eighth * swing * rng.uniform(0.97, 1.03)
            i += 1
        y += _crackle(n, rng, density=6, amp=0.012)
        gain = 0.7
    elif cls == "Sad/Depressed":
        bpm = rng.uniform(45, 65)
        step = 60.0 / bpm * 2.0
        pos, i = 0.0, 0
        while pos < seconds - 3.0:
            start = int(pos * SR)
            root = rng.uniform(-28, -16)
            ln = int(2.8 * SR)
            trem = 1.0 + 0.15 * np.sin(
                2 * np.pi * 3.5 * np.arange(ln) / SR)
            seg = sum(_fm(_hz(root + s), ln, ratio=0.5,
                          index=rng.uniform(0.4, 0.9), decay_s=2.5)
                      for s in _MINOR) / len(_MINOR) * trem
            seg *= _adsr(ln, 0.6, 1.0, 0.5, 1.0)
            end = min(start + ln, n)
            y[start:end] += seg[:end - start]
            pos += step * rng.uniform(0.97, 1.03)
            i += 1
        y += _crackle(n, rng, density=1, amp=0.003)
        y = _tilt(y, 500.0, 2.4)                          # very dark
        gain = 0.3
    else:
        raise ValueError(cls)

    y = y / max(np.abs(y).max(), 1e-9) * gain
    y = np.clip(y, -1, 1).astype(np.float32)
    return np.stack([y, y], axis=1)


def generate(root: str, per_class: int = 12, seconds: float = 30.0,
             seed: int = 1000) -> int:
    from ame_tpu_torch.io.wav import write_wav
    from ame_tpu_torch.models.mood_cnn import MOOD_CLASSES

    rng = np.random.default_rng(seed)
    count = 0
    for cls in MOOD_CLASSES:
        d = os.path.join(root, cls.replace("/", "-"))
        os.makedirs(d, exist_ok=True)
        for k in range(per_class):
            y = synth_track_oof(cls, rng, seconds)
            write_wav(os.path.join(d, f"{k:03d}.wav"), y, SR)
            count += 1
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root")
    ap.add_argument("--per-class", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1000)
    args = ap.parse_args(argv)
    n = generate(args.out_root, args.per_class, args.seconds, args.seed)
    print(f"wrote {n} tracks under {args.out_root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
