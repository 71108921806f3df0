"""Technical features: tempo, spectral centroid, RMS, key, and the
reference's bucket thresholds (ai_tagger.py:79-89).

Port of ``ame_tpu/analysis/features.py``. Tempo follows the standard
onset-autocorrelation recipe: log-mel spectral flux onset envelope, FFT
autocorrelation, log-normal prior centred at 120 BPM, argmax over
30-300 BPM. Key: chroma fold of the power spectrum, correlated with the
24 Krumhansl-Schmuckler profiles. The classification buckets are the
reference's:
  tempo:      > 120 fast | > 90 moderate | else slow
  centroid:   > 2000 bright | > 1000 warm | else dark
  rms:        > 0.1 dense | > 0.05 moderate | else sparse

Every function takes any number of leading batch dimensions on ``y`` /
``mag`` and returns one value per track.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ame_tpu_torch.analysis import stft as S


def _centroid(mag: torch.Tensor, sr: float) -> torch.Tensor:
    """Mean over frames of the magnitude-weighted frequency centroid."""
    freqs = torch.linspace(0.0, sr / 2.0, mag.shape[-2],
                           device=mag.device)[:, None]
    cent = torch.sum(freqs * mag, dim=-2) / torch.clamp(
        torch.sum(mag, dim=-2), min=1e-10)
    return cent.mean(-1)


def _flux(mel: torch.Tensor) -> torch.Tensor:
    """Onset envelope of a power mel spectrogram: mean over bands of the
    half-wave-rectified first time difference of its dB."""
    db = S.power_to_db(mel)
    return torch.clamp(db[..., 1:] - db[..., :-1], min=0.0).mean(-2)


def tempo_scores(env: torch.Tensor, sr: float, hop: int = 512,
                 start_bpm: float = 120.0):
    """(bpms [n], score [..., n]) of an onset envelope [..., n]: the
    autocorrelation at each lag under the log-normal prior (std one
    octave), -1 outside 30..300 BPM. The tempo is bpms[argmax(score)]."""
    env = env - env.mean(-1, keepdim=True)
    n = env.shape[-1]
    E = torch.fft.rfft(env, 2 * n)
    ac = torch.clamp(torch.fft.irfft(E * torch.conj(E), 2 * n)[..., :n],
                     min=0.0)
    fps = sr / hop
    lags = torch.arange(n, dtype=torch.float32, device=env.device)
    bpms = torch.where(lags > 0, 60.0 * fps / torch.clamp(lags, min=1),
                       math.inf)
    prior = torch.exp(-0.5 * ((torch.log2(torch.clamp(bpms, min=1e-6))
                               - float(np.log2(start_bpm))) ** 2))
    valid = (bpms >= 30.0) & (bpms <= 300.0)
    return bpms, torch.where(valid, ac * prior, -1.0)


def _tempo(env: torch.Tensor, sr: float, hop: int = 512,
           start_bpm: float = 120.0) -> torch.Tensor:
    bpms, score = tempo_scores(env, sr, hop, start_bpm)
    return bpms[torch.argmax(score, dim=-1)]


def onset_envelope(y: torch.Tensor, sr: float, hop: int = 512):
    """Spectral flux on the dB mel spectrogram of y [..., N]."""
    return _flux(S.melspectrogram(y, sr, 2048, 128, hop))


def tempo_bpm(y: torch.Tensor, sr: float, hop: int = 512,
              start_bpm: float = 120.0) -> torch.Tensor:
    """Global tempo estimate in BPM."""
    return _tempo(onset_envelope(y, sr, hop), sr, hop, start_bpm)


def spectral_centroid_mean(y: torch.Tensor, sr: float, hop: int = 512):
    """Mean over frames of the magnitude-weighted frequency centroid."""
    return _centroid(S.stft_mag(y, 2048, hop), sr)


def rms_mean(y: torch.Tensor, frame_length: int = 2048, hop: int = 512):
    """Mean over frames of the per-frame RMS (centred frames)."""
    frames = S.frame_signal(y, frame_length, hop)
    return torch.sqrt(torch.mean(frames * frames, dim=-1)).mean(-1)


KEY_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A",
             "A#", "B")

# Krumhansl-Schmuckler tonal-hierarchy profiles (major / minor) — the
# standard probe-tone ratings used for key finding; correlation against
# all 24 rotations picks the key.
_KS_MAJOR = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09,
                      2.52, 5.19, 2.39, 3.66, 2.29, 2.88], np.float32)
_KS_MINOR = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53,
                      2.54, 4.75, 3.98, 2.69, 3.34, 3.17], np.float32)


def _key_profiles() -> np.ndarray:
    """[24, 12] z-scored profiles: rows 0-11 major keys C..B, 12-23
    minor. Row k's tonic is KEY_NAMES[k % 12]."""
    rows = [np.roll(_KS_MAJOR, k) for k in range(12)] + \
           [np.roll(_KS_MINOR, k) for k in range(12)]
    P = np.stack(rows)
    P = P - P.mean(axis=1, keepdims=True)
    return (P / np.linalg.norm(P, axis=1, keepdims=True)).astype(np.float32)


def _chroma_fold(sr: float, n_fft: int) -> np.ndarray:
    """[12, bins] pitch-class fold matrix (host-built): each STFT bin in
    55 Hz..5 kHz votes for its nearest equal-tempered pitch class."""
    nbins = n_fft // 2 + 1
    freqs = np.linspace(0.0, sr / 2.0, nbins)
    midi = 69.0 + 12.0 * np.log2(np.maximum(freqs, 1e-9) / 440.0)
    pc = np.round(midi).astype(int) % 12
    valid = (freqs >= 55.0) & (freqs <= 5000.0)
    fold = np.zeros((12, nbins), np.float32)
    fold[pc[valid], np.arange(nbins)[valid]] = 1.0
    return fold


def key_index(mag: torch.Tensor, sr: float) -> torch.Tensor:
    """Key estimate from an STFT magnitude [..., bins, frames]: chroma
    fold -> time-mean pitch-class energy -> correlation with the 24 K-S
    profiles -> argmax index (0-11 major C..B, 12-23 minor), as float."""
    fold = S.on_device(_chroma_fold, (float(sr), 2 * (mag.shape[-2] - 1)),
                       mag.device)
    chroma = torch.matmul(fold, mag * mag).mean(-1)            # [..., 12]
    c = chroma - chroma.mean(-1, keepdim=True)
    c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True),
                        min=1e-12)
    P = S.on_device(_key_profiles, (), mag.device)
    return torch.argmax(torch.matmul(P, c[..., None])[..., 0],
                        dim=-1).to(torch.float32)


def key_name(idx: int) -> str:
    idx = int(idx)
    return f"{KEY_NAMES[idx % 12]} {'major' if idx < 12 else 'minor'}"


def extract_all(y: torch.Tensor, sr: float):
    """All technical features of y [..., N] from one shared STFT: returns
    (tempo_bpm, centroid_mean, rms_mean, key_idx), each [...]. The STFT
    feeds the centroid, the key chroma and the onset envelope's mel
    spectrogram."""
    mag = S.stft_mag(y, 2048, 512)                  # [..., bins, frames]
    tempo = _tempo(_flux(S.mel_power(mag, sr, 128)), sr)
    return tempo, _centroid(mag, sr), rms_mean(y), key_index(mag, sr)


def classify(tempo: float, centroid: float, rms: float) -> dict:
    """The reference's exact bucket thresholds (ai_tagger.py:87-89)."""
    tempo_class = ("fast" if tempo > 120 else
                   "moderate" if tempo > 90 else "slow")
    brightness = ("bright" if centroid > 2000 else
                  "warm" if centroid > 1000 else "dark")
    density = ("dense" if rms > 0.1 else
               "moderate" if rms > 0.05 else "sparse")
    return {"tempo_class": tempo_class, "brightness": brightness,
            "density": density}
