"""The Musicologist on the device: a technical brief for a song (reference
C13, ai_tagger.py:56-103; port of ``ame_tpu/analysis/musicologist.py``).

Contract, as the reference's:
  * analyzes the ORIGINAL input file, first 30 s, mono at 22 050 Hz
    (quirk Q11; ai_tagger.py:66),
  * mood via a 128x128x3 normalized mel-spectrogram image -> CNN ->
    argmax -> label class (ai_tagger.py:47-54, 69-73),
  * tempo / spectral centroid / RMS features with identical bucket
    thresholds (ai_tagger.py:87-89), and the key,
  * ``analyze_song`` returns {"mood", "tempo": "<n> BPM (<class>)",
    "brightness", "density", "key"} or {"error": str} and never raises
    for a track; asking for a device the process does not have raises.

One pass on the device computes the whole brief of a batch of tracks
(B images, one CNN batch of B, B feature rows) and ends in one host fetch
of [B, 8] numbers: 4 logits, tempo, centroid, RMS, key. Entry points take
``device`` ("cuda" by default; "cpu" runs the same code on the host).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as Fn

from ame_tpu_torch import precision
from ame_tpu_torch.analysis import features as F
from ame_tpu_torch.analysis import stft as S
from ame_tpu_torch.models import mood_cnn
from ame_tpu_torch.ops.resample import input_needed, resample

log = logging.getLogger("ame_tpu_torch.analysis")

ANALYSIS_SR = 22050
ANALYSIS_SECONDS = 30.0
_MAX_N = int(ANALYSIS_SECONDS * ANALYSIS_SR)

_warned_untrained = False


def _warn_untrained_once():
    global _warned_untrained
    if not _warned_untrained:
        _warned_untrained = True
        log.warning("mood CNN running with untrained (seed) weights — "
                    "set AME_TPU_MOOD_WEIGHTS to a trained checkpoint")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the Musicologist runs on the "
                           "card (device='cpu' runs it on the host)")
    return dev


def load_for_analysis(path: str, device="cuda") -> torch.Tensor:
    """Decode -> mono mixdown -> 22 050 Hz -> first 30 s ([N] float32 on
    ``device``). A longer track is cut on the host, before the mixdown, to
    the input samples that the 30 s of output read
    (``resample.input_needed``): the kept output is exactly that of the
    whole track's mixdown and resample, at a fraction of their host time
    and device memory."""
    from ame_tpu_torch.io import read_audio
    audio, sr = read_audio(path)
    if sr == ANALYSIS_SR:
        keep = _MAX_N
    else:
        keep = input_needed(_MAX_N, sr, ANALYSIS_SR)
    mono = np.mean(audio[:keep], axis=1).astype(np.float32)
    y = torch.from_numpy(mono).to(device)
    if sr != ANALYSIS_SR:
        y = resample(y, sr, ANALYSIS_SR)[:_MAX_N]
    return y


def spectrogram_image(y: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 128, 128, 3]: mel power -> dB (ref = max) ->
    min-max normalize -> bilinear resize to 128x128 -> 3 channels
    (ai_tagger.py:47-54). The resize antialiases, as ``jax.image.resize``
    does: a 30 s window has 1292 frames, and without the antialias the
    image moves by up to 0.6."""
    size = mood_cnn.IMG_SIZE
    mel = S.melspectrogram(y, float(ANALYSIS_SR), 2048, size, 512)
    db = S.power_to_db(mel)
    lo = db.amin(dim=(-2, -1), keepdim=True)
    hi = db.amax(dim=(-2, -1), keepdim=True)
    norm = (db - lo) / torch.clamp(hi - lo, min=1e-6)
    lead = norm.shape[:-2]
    img = Fn.interpolate(norm.reshape(-1, 1, *norm.shape[-2:]),
                         size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)
    return img.reshape(*lead, size, size, 1).expand(*lead, size, size, 3)


@torch.no_grad()
def _analyze_batch(model: mood_cnn.MoodCNN,
                   ys: torch.Tensor) -> torch.Tensor:
    """The whole brief of ys [B, N] in one device pass: [B, 8] = 4 logits,
    tempo, centroid, RMS, key (left on the device)."""
    precision.apply()
    logits = model(spectrogram_image(ys))                   # [B, 4]
    feats = torch.stack(F.extract_all(ys, float(ANALYSIS_SR)), dim=1)
    return torch.cat([logits, feats], dim=1)


def _brief_from_vec(vec: np.ndarray) -> dict:
    mood = mood_cnn.MOOD_CLASSES[int(np.argmax(vec[:4]))]
    tempo, centroid, rms = float(vec[4]), float(vec[5]), float(vec[6])
    b = F.classify(tempo, centroid, rms)
    return {
        "mood": mood,
        "tempo": f"{tempo:.0f} BPM ({b['tempo_class']})",
        "brightness": b["brightness"],
        "density": b["density"],
        "key": F.key_name(vec[7]),
    }


def analyze_waveform(y: torch.Tensor) -> dict:
    """Brief from an already-conditioned [N] 22.05 kHz waveform, on the
    device y lies on: one device pass, one host fetch."""
    model, trained = mood_cnn.load_params(device=y.device)
    vec = _analyze_batch(model, y[None])[0].cpu().numpy()
    brief = _brief_from_vec(vec)
    if not trained:
        _warn_untrained_once()
    log.info("technical brief: %s", brief)
    return brief


def analyze_song(audio_file_path: str, device="cuda") -> dict:
    """File-level entry point; error-dict contract of
    ai_tagger.analyze_song."""
    dev = _device(device)
    log.info("analyzing song: %s", audio_file_path)
    try:
        return analyze_waveform(load_for_analysis(audio_file_path, dev))
    except Exception as e:
        log.exception("song analysis failed")
        return {"error": str(e)}


def analyze_batch(paths: list[str], device="cuda") -> list[dict]:
    """Fleet-mode batched analysis: tracks are grouped by conditioned
    length (almost always one group, the 30 s window) and each group runs
    as one device pass and one fetch; a track that cannot be loaded gets
    an error dict. The briefs equal the per-track path's."""
    dev = _device(device)
    ys: list = []
    briefs: list[dict | None] = []
    for p in paths:
        try:
            ys.append(load_for_analysis(p, dev))
            briefs.append(None)
        except Exception as e:
            ys.append(None)
            briefs.append({"error": str(e)})
    groups: dict[int, list[int]] = {}
    for i, y in enumerate(ys):
        if y is not None:
            groups.setdefault(y.shape[0], []).append(i)
    if groups:
        model, trained = mood_cnn.load_params(device=dev)
        for idxs in groups.values():
            batch = torch.stack([ys[i] for i in idxs])
            vecs = _analyze_batch(model, batch).cpu().numpy()
            for j, i in enumerate(idxs):
                briefs[i] = _brief_from_vec(vecs[j])
        if not trained:
            _warn_untrained_once()
    return briefs  # type: ignore[return-value]
