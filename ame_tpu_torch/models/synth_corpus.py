"""Synthetic labeled corpus for the mood CNN (the port's own copy of
``ame_tpu/models/synth_corpus.py``: the same numpy generator, so the same
seed gives the same tracks; it writes through ``ame_tpu_torch.io.wav``).

The reference's trained weights are unrecoverable (.MISSING_LARGE_BLOBS),
and no labeled mood dataset ships in this environment, so the mood model is
trained on SYNTHETIC program material whose acoustic properties encode the
four reference classes (ai_tagger label encoder, SURVEY.md §0):

  Angry/Anxious  — fast tempo, distorted (clipped saw) hits, dissonant
                   intervals (tritone/minor 2nd), heavy noise floor, dense.
  Calm/Content   — slow tempo, soft sine pads on major triads, long decay
                   envelopes, sparse, faint noise.
  Happy/Excited  — fast tempo, bright major-triad arpeggios in a high
                   register, moderate noise, dense.
  Sad/Depressed  — slow tempo, low-register minor triads, lowpassed
                   (dark), quiet, sparse.

These axes (tempo, register/brightness, mode, distortion, density) are the
same axes the Musicologist reads and the PROMPT_LIBRARY voices, so the
learned decision surface is aligned with how the labels are USED downstream.
Heuristic labels on synthetic audio are the stated round-2 scope; swap in a
real labeled corpus via models/train_mood.py for production-quality moods.

Usage:
    python -m ame_tpu_torch.models.synth_corpus <out_root> [--per-class N]
        [--seconds S] [--seed S]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SR = 22050  # matches the Musicologist's analysis rate (no resample needed)

_A4 = 440.0


def _hz(semitones_from_a4: float) -> float:
    return _A4 * 2.0 ** (semitones_from_a4 / 12.0)


# intervals in semitones relative to the chord root
_MAJOR = (0, 4, 7, 12)
_MINOR = (0, 3, 7, 12)
_DISSONANT = (0, 1, 6, 13)  # minor 2nd + tritone stack


def _tone(freq, n, sr, shape="sine", rng=None):
    t = np.arange(n) / sr
    ph = 2 * np.pi * freq * t
    if shape == "saw":
        return 2.0 * ((freq * t) % 1.0) - 1.0
    if shape == "square":
        return np.sign(np.sin(ph))
    if shape == "triangle":
        return 2.0 * np.abs(2.0 * ((freq * t) % 1.0) - 1.0) - 1.0
    if shape == "overtones":
        # additive overtone stack with random rolloff — widens the timbre
        # space within the additive family (the OOF validation corpus uses
        # physical-model/FM synthesis instead, ame_tpu/models/oof_corpus.py)
        rolloff = rng.uniform(1.2, 2.5) if rng is not None else 1.8
        y = np.zeros(n)
        for h in range(1, 6):
            if freq * h < sr / 2:
                y += np.sin(2 * np.pi * freq * h * t) / h ** rolloff
        return y
    return np.sin(ph)


def _env(n, sr, attack_s, decay_s):
    a = max(int(attack_s * sr), 1)
    e = np.ones(n)
    e[:a] = np.linspace(0.0, 1.0, a)
    e *= np.exp(-np.arange(n) / (decay_s * sr))
    return e


def synth_track(cls: str, rng: np.random.Generator,
                seconds: float = 30.0, sr: int = SR) -> np.ndarray:
    """One labeled track as [N, 2] float32 in [-1, 1]."""
    n = int(seconds * sr)
    y = np.zeros(n)

    # timbres are drawn per-track from class-plausible additive shapes so
    # the model cannot key on one oscillator's texture (round-3: the OOF
    # evaluation showed the round-2 single-timbre corpus taught exactly
    # that shortcut)
    if cls == "Angry/Anxious":
        bpm = rng.uniform(150, 185)
        chord = _DISSONANT
        shape = rng.choice(["saw", "square", "overtones"])
        roots = rng.uniform(-10, 2, 8)       # mid register
        hit_len, decay = 0.25, 0.12
        noise, gain, drive = rng.uniform(0.03, 0.09), 0.9, rng.uniform(3, 6)
        events_per_beat = 2
    elif cls == "Calm/Content":
        bpm = rng.uniform(58, 78)
        chord = _MAJOR
        shape = rng.choice(["sine", "triangle", "overtones"])
        roots = rng.uniform(-14, -4, 8)
        hit_len, decay = 2.5, 1.2
        noise, gain, drive = rng.uniform(0.002, 0.008), 0.35, 1.0
        events_per_beat = 0.5
    elif cls == "Happy/Excited":
        bpm = rng.uniform(122, 160)
        chord = _MAJOR
        shape = rng.choice(["sine", "triangle", "square", "overtones"])
        roots = rng.uniform(0, 12, 8)        # bright, high register
        hit_len, decay = 0.3, 0.15
        noise, gain, drive = rng.uniform(0.01, 0.04), 0.7, 1.0
        events_per_beat = 2
    elif cls == "Sad/Depressed":
        bpm = rng.uniform(48, 68)
        chord = _MINOR
        shape = rng.choice(["sine", "triangle", "overtones"])
        roots = rng.uniform(-26, -14, 8)     # low register, dark
        hit_len, decay = 2.0, 1.0
        noise, gain, drive = rng.uniform(0.002, 0.006), 0.3, 1.0
        events_per_beat = 0.5
    else:
        raise ValueError(cls)

    beat = 60.0 / bpm
    step = beat / events_per_beat
    pos = 0.0
    i = 0
    while pos < seconds - hit_len:
        root = roots[i % len(roots)] + rng.normal(0, 0.3)
        ln = int(hit_len * sr)
        start = int(pos * sr)
        seg = np.zeros(ln)
        # arpeggiate for the fast classes, stack a pad for the slow ones
        if events_per_beat >= 2:
            note = chord[i % len(chord)]
            seg += _tone(_hz(root + note), ln, sr, shape, rng)
        else:
            for note in chord:
                seg += _tone(_hz(root + note), ln, sr, shape, rng) / len(chord)
        seg *= _env(ln, sr, 0.005 if events_per_beat >= 2 else 0.4, decay)
        end = min(start + ln, n)
        y[start:end] += seg[:end - start]
        pos += step * rng.uniform(0.95, 1.05)
        i += 1

    y = np.tanh(y * drive) * gain
    y += rng.normal(0, noise, n)
    if cls == "Sad/Depressed":
        # darken: smooth spectral rolloff (FFT-domain — corpus synthesis,
        # not a DSP-engine code path); corner/slope randomized so the
        # model keys on "dark", not on one fixed filter signature
        spec = np.fft.rfft(y)
        f = np.fft.rfftfreq(n, 1.0 / sr)
        corner = rng.uniform(600.0, 1400.0)
        slope = rng.uniform(1.5, 2.5)
        spec *= 1.0 / (1.0 + (f / corner) ** slope)
        y = np.fft.irfft(spec, n)
    y = np.clip(y, -1, 1).astype(np.float32)
    return np.stack([y, y], axis=1)


def generate(root: str, per_class: int = 24, seconds: float = 30.0,
             seed: int = 0) -> int:
    from ame_tpu_torch.io.wav import write_wav
    from ame_tpu_torch.models.mood_cnn import MOOD_CLASSES

    rng = np.random.default_rng(seed)
    count = 0
    for cls in MOOD_CLASSES:
        d = os.path.join(root, cls.replace("/", "-"))
        os.makedirs(d, exist_ok=True)
        for k in range(per_class):
            y = synth_track(cls, rng, seconds)
            write_wav(os.path.join(d, f"{k:03d}.wav"), y, SR)
            count += 1
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root")
    ap.add_argument("--per-class", type=int, default=24)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n = generate(args.out_root, args.per_class, args.seconds, args.seed)
    print(f"wrote {n} tracks under {args.out_root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
