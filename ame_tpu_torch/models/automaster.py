"""Differentiable auto-mastering: fit the quality chain's settings by
gradient descent (port of ``ame_tpu/models/automaster.py``).

Every parameter of the quality sub-chain (analog character, the 4-band EQ,
width, and with ``optimize_multiband`` the multiband thresholds and
ratios) is a tensor, and the sub-chain is differentiable in all of them,
so Adam can fit them so that the master's log-mel profile (and, opt-in,
its band dynamics, stereo field and true peak) matches a reference track.

The objective and its pieces are the reference's:

  * spectral: the time-averaged log-mel profile (64 bands) of the mono
    mixdown, at one FFT size or at the two of ``MULTI_RES_FFTS``;
  * band dynamics: the standard deviation of 0.4 s framed RMS in dB per
    LR4 band (what makes the multiband parameters identifiable);
  * stereo field: the side/mid energy ratio in dB per band (the width
    parameter's only signal);
  * true peak: a squared hinge on the 4x-oversampled true peak above
    ``tp_target``.

On the card every filter of the chain and of the loss is a K5 launch
(``ops/cascade_scan.py``) through ``scan_iir.SosfiltFn``, whose backward is
K5 in reverse and the ``sos_grad`` reduction; on the CPU the same chain
runs the plain tile-conv, which autograd differentiates.
"""

from __future__ import annotations

import torch

from ame_tpu_torch import precision
from ame_tpu_torch.analysis.stft import melspectrogram
from ame_tpu_torch.device import resolve_device
from ame_tpu_torch.graph.multiband import multiband_quality, quality_band_split
from ame_tpu_torch.ops import eq, saturate, stereo
from ame_tpu_torch.ops.loudness import true_peak_db

N_MELS = 64
N_FFT = 2048
MULTI_RES_FFTS = (512, 2048)    # transient + tonal windows
DYN_FRAME_S = 0.4               # band-dynamics RMS frame (BS.1770 block)


def _logmel_profile(x: torch.Tensor, sample_rate: float,
                    n_fft: int = N_FFT) -> torch.Tensor:
    """Time-averaged log-mel energy profile [N_MELS] of a stereo track."""
    mono = torch.mean(x, dim=1)
    mel = melspectrogram(mono, float(sample_rate), n_fft, N_MELS, n_fft // 2)
    return 10.0 * torch.log10(torch.clamp(torch.mean(mel, dim=1),
                                          min=1e-10))


def _band_dynamics(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Per-band dB-RMS frame standard deviation [3] over the LR4 bands of
    the multiband compressor."""
    frame = max(int(DYN_FRAME_S * sample_rate), 1)
    if x.shape[0] < 2 * frame:
        raise ValueError(
            f"band-dynamics loss needs >= {2 * frame} samples "
            f"(2 x {DYN_FRAME_S}s frames) — got {x.shape[0]}; "
            "use dynamics_weight=0 for short clips")
    outs = []
    for b in quality_band_split(x, float(sample_rate)):
        n = (b.shape[0] // frame) * frame
        sq = torch.mean(b[:n].reshape(-1, frame, b.shape[1]) ** 2,
                        dim=(1, 2))
        db = 10.0 * torch.log10(torch.clamp(sq, min=1e-10))
        outs.append(torch.std(db, correction=0))
    return torch.stack(outs)


def _stereo_field(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Per-band side/mid energy ratio in dB [3] — the width signature."""
    mid = (x[:, :1] + x[:, 1:]) * 0.5
    side = (x[:, :1] - x[:, 1:]) * 0.5
    bm = quality_band_split(mid, float(sample_rate))
    bs = quality_band_split(side, float(sample_rate))
    outs = []
    for m, s in zip(bm, bs):
        em = torch.mean(m * m) + 1e-10
        es = torch.mean(s * s) + 1e-10
        outs.append(10.0 * torch.log10(es / em))
    return torch.stack(outs)


def _chain(x: torch.Tensor, theta: dict, sample_rate: float) -> torch.Tensor:
    """The differentiable sub-chain: analog character + quality EQ + width,
    plus quality multiband compression when theta has band parameters.
    theta: dict of unconstrained tensors."""
    analog = 50.0 * torch.sigmoid(theta["analog_raw"])      # [0, 50] %
    width = 2.0 * torch.sigmoid(theta["width_raw"])         # [0, 2]
    gains = 6.0 * torch.tanh(theta["eq_raw"])               # [-6, 6] dB
    y = saturate.analog_character_quality(x, sample_rate, analog)
    y = eq.apply_eq_quality(y, sample_rate, gains[0], -gains[1], gains[2],
                            gains[3])
    y = stereo.stereo_width_quality(y, width)
    if "mb_thresh_raw" in theta:
        threshs = -40.0 * torch.sigmoid(theta["mb_thresh_raw"])  # [-40, 0]
        ratios = 1.0 + 9.0 * torch.sigmoid(theta["mb_ratio_raw"])  # [1, 10]
        y = multiband_quality(y, sample_rate, threshs, ratios)
    return y


def _theta_to_settings(theta: dict) -> dict:
    with torch.no_grad():
        analog = float(50.0 * torch.sigmoid(theta["analog_raw"]))
        width = float(2.0 * torch.sigmoid(theta["width_raw"]))
        gains = (6.0 * torch.tanh(theta["eq_raw"])).cpu().numpy()
        out = {
            "analog_character": analog,
            "bass_boost": float(gains[0]),
            "mid_cut": float(-gains[1]),
            "presence_boost": float(gains[2]),
            "treble_boost": float(gains[3]),
            "width": width,
        }
        if "mb_thresh_raw" in theta:
            threshs = (-40.0 * torch.sigmoid(theta["mb_thresh_raw"])).cpu()
            ratios = (1.0 + 9.0 * torch.sigmoid(theta["mb_ratio_raw"])).cpu()
            out.update({
                "multiband": True,
                "low_thresh": float(threshs[0]),
                "low_ratio": float(ratios[0]),
                "mid_thresh": float(threshs[1]),
                "mid_ratio": float(ratios[1]),
                "high_thresh": float(threshs[2]),
                "high_ratio": float(ratios[2]),
            })
    return out


def _perceptual_targets(target_track: torch.Tensor, sample_rate: float,
                        resolutions, dyn_w: float, stereo_w: float):
    """Target statistics, computed once: the log-mel profile at each FFT
    resolution, and the band-dynamics and stereo-field signatures."""
    t = target_track
    with torch.no_grad():
        profs = tuple(_logmel_profile(t, sample_rate, n) for n in resolutions)
        dyn = (_band_dynamics(t, sample_rate) if dyn_w > 0.0
               else t.new_zeros(3))
        field = (_stereo_field(t, sample_rate) if stereo_w > 0.0
                 else t.new_zeros(3))
    return profs, dyn, field


def _loss_fn(theta: dict, x: torch.Tensor, target_profile: torch.Tensor,
             sample_rate: float) -> torch.Tensor:
    y = _chain(x, theta, sample_rate)
    prof = _logmel_profile(y, sample_rate)
    return torch.mean((prof - target_profile) ** 2)


def _perceptual_loss(theta: dict, x: torch.Tensor, target_profs,
                     target_dyn: torch.Tensor, target_field: torch.Tensor,
                     sample_rate: float, resolutions, dyn_w: float,
                     stereo_w: float, tp_w: float,
                     tp_target: float) -> torch.Tensor:
    y = _chain(x, theta, sample_rate)
    loss = x.new_zeros(())
    for prof_t, n_fft in zip(target_profs, resolutions):
        prof = _logmel_profile(y, sample_rate, n_fft)
        loss = loss + torch.mean((prof - prof_t) ** 2) / len(resolutions)
    if dyn_w > 0.0:
        dyn = _band_dynamics(y, sample_rate)
        loss = loss + dyn_w * torch.mean((dyn - target_dyn) ** 2)
    if stereo_w > 0.0:
        field = _stereo_field(y, sample_rate)
        loss = loss + stereo_w * torch.mean((field - target_field) ** 2)
    if tp_w > 0.0:
        over = torch.relu(true_peak_db(y) - tp_target)
        loss = loss + tp_w * over * over
    return loss


def init_theta(optimize_multiband: bool, device) -> dict:
    """The reference's starting point: character ~0, width 1, flat EQ; with
    multiband, thresholds at -20 dB (the detector must cross them, or
    max(level - th, 0) has no gradient) and ratios ~2.1."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device,
                            requires_grad=True)
    theta = {"analog_raw": t(-4.0), "width_raw": t(0.0),
             "eq_raw": t([0.0] * 4)}
    if optimize_multiband:
        theta["mb_thresh_raw"] = t([0.0] * 3)
        theta["mb_ratio_raw"] = t([-2.0] * 3)
    return theta


def fit_settings(x, sample_rate: float, target,
                 target_is_profile: bool = False, steps: int = 200,
                 lr: float = 0.05, optimize_multiband: bool = False,
                 multi_resolution: bool = False,
                 dynamics_weight: float | None = None,
                 stereo_weight: float = 0.0, true_peak_weight: float = 0.0,
                 tp_target: float = -1.0, verbose: bool = False,
                 device="cuda") -> dict:
    """Fit EQ/width/character so ``x`` spectrally matches ``target``.

    Args:
      x: [N, 2] source track (numpy or tensor).
      target: [M, 2] reference track, or a precomputed [N_MELS] log-mel
        profile when ``target_is_profile``.
      steps / lr: Adam schedule (``torch.optim.Adam``, optax's defaults).
      optimize_multiband: also fit the 6 multiband compressor parameters;
        implies a band-dynamics term.
      multi_resolution: spectral loss over MULTI_RES_FFTS windows.
      dynamics_weight: weight of the band-dynamics term (default 1.0 when
        optimize_multiband else 0.0); needs a target track.
      stereo_weight: weight of the per-band side/mid stereo-field term.
      true_peak_weight / tp_target: hinge penalty on the output's true
        peak above ``tp_target`` dBTP.
      device: "cuda" (default; raises without a card) or "cpu".

    Returns a reference-schema settings dict (multiband keys included when
    optimized; add lufs yourself) with the final ``loss``.
    """
    dev = resolve_device(device, "fit_settings")
    precision.apply()
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    sample_rate = float(sample_rate)
    if dynamics_weight is None:
        dynamics_weight = 1.0 if optimize_multiband else 0.0
    perceptual = (optimize_multiband or multi_resolution
                  or dynamics_weight > 0 or stereo_weight > 0
                  or true_peak_weight > 0)
    if perceptual and target_is_profile:
        raise ValueError("perceptual objectives need a target track, "
                         "not a precomputed profile")

    theta = init_theta(optimize_multiband, dev)
    if perceptual:
        resolutions = MULTI_RES_FFTS if multi_resolution else (N_FFT,)
        target_profs, target_dyn, target_field = _perceptual_targets(
            target, sample_rate, resolutions, dynamics_weight, stereo_weight)

        def loss_fn():
            return _perceptual_loss(
                theta, x, target_profs, target_dyn, target_field,
                sample_rate, resolutions, float(dynamics_weight),
                float(stereo_weight), float(true_peak_weight),
                float(tp_target))
    else:
        if target_is_profile:
            target_profile = target
        else:
            with torch.no_grad():
                target_profile = _logmel_profile(target, sample_rate)

        def loss_fn():
            return _loss_fn(theta, x, target_profile, sample_rate)

    opt = torch.optim.Adam(theta.values(), lr=lr)
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        if verbose and i % 20 == 0:
            with torch.no_grad():
                print(f"automaster step {i}: loss {float(loss_fn()):.4f}")

    out = _theta_to_settings(theta)
    with torch.no_grad():
        out["loss"] = float(loss_fn())
    return out
