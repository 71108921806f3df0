"""STFT / mel-spectrogram pipeline of the Musicologist (librosa's feature
stack, reference N9).

Port of ``ame_tpu/analysis/stft.py``: n_fft 2048, hop 512, periodic Hann
window, centred frames (zero padding), power mel spectrogram with a
128-band Slaney filterbank, ``power_to_db`` with ref = max and an 80 dB
floor. Every function takes any number of leading batch dimensions: a
batch of tracks [B, N] is B independent rows, and ``power_to_db``'s
reference max is each track's own.

The window and the filterbank are built on the host in float64 (numpy
copies of the reference's) and kept on the device (``on_device``), so a
call uploads nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    # periodic Hann (librosa/scipy sym=False convention for STFT)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


@functools.lru_cache(maxsize=32)
def on_device(build, args: tuple, device: torch.device) -> torch.Tensor:
    """``build(*args)``, a host-built table, as float32 on ``device``; built
    and uploaded once per (table, device). Callers only read it."""
    return torch.as_tensor(build(*args), dtype=torch.float32, device=device)


def frame_signal(y: torch.Tensor, frame_length: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """[..., N] -> [..., n_frames, frame_length], zero-padded centred
    frames (a strided view of the padded signal)."""
    if center:
        y = F.pad(y, (frame_length // 2, frame_length // 2))
    return y.unfold(-1, frame_length, hop)


def stft_mag(y: torch.Tensor, n_fft: int = 2048,
             hop: int = 512) -> torch.Tensor:
    """Magnitude STFT: [..., N] -> [..., n_fft//2+1, n_frames] (librosa
    layout)."""
    frames = frame_signal(y, n_fft, hop)
    win = on_device(hann_window, (n_fft,), y.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return spec.abs().transpose(-1, -2)


# ---------------------------------------------------------------------------
# Slaney mel filterbank
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10)
                                               / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    f = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(sr: float, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] slaney-normalized triangular filters."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney norm: equal-area triangles
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb


def mel_power(mag: torch.Tensor, sr: float,
              n_mels: int = 128) -> torch.Tensor:
    """Power mel spectrogram [..., n_mels, frames] of a magnitude STFT
    [..., bins, frames] (one matmul)."""
    n_fft = 2 * (mag.shape[-2] - 1)
    fb = on_device(mel_filterbank, (float(sr), n_fft, n_mels), mag.device)
    return torch.matmul(fb, mag * mag)


def melspectrogram(y: torch.Tensor, sr: float, n_fft: int = 2048,
                   n_mels: int = 128, hop: int = 512) -> torch.Tensor:
    """Power mel spectrogram [..., n_mels, n_frames]."""
    return mel_power(stft_mag(y, n_fft, hop), sr, n_mels)


def power_to_db(S: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """10*log10(S / max(S)), floored at -top_db (librosa ref=np.max); the
    max is taken over the last two axes (each track's own)."""
    ref = S.amax(dim=(-2, -1), keepdim=True)
    db = 10.0 * torch.log10(torch.clamp(S, min=1e-10)) \
        - 10.0 * torch.log10(torch.clamp(ref, min=1e-10))
    return torch.clamp(db, min=-top_db)
