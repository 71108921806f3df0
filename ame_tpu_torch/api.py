"""Public API of the port — the reference-compatible entry points.

Port of ``ame_tpu/api.py``: ``master_file``, ``master_array`` and
``process_audio``. The device is explicit: ``device="cuda"`` by default,
which raises where there is no card; pass ``device="cpu"`` to run the
chain's plain PyTorch versions on the host.

``process_audio(settings, status_cb, progress_cb, art_cb, tag_cb)`` keeps
the reference's observability contract (SURVEY.md §5.5):

  * status strings carry the parsed severity prefixes ``Success:`` /
    ``Error:`` / ``Failed:`` (quirk Q13 — the GUI keys off these),
  * progress is reported as (step, total) with total = num_chunks + 4,
    where num_chunks = ceil(duration / 30 s), from the first emission on,
  * MP3 / analysis / art are best-effort sidecars; only the master path is
    fatal. The analysis runs on ``device`` (``auto_generate_prompt``: the
    Musicologist's brief becomes the tag line ``Mood: ... | Tempo: ... |
    Brightness: ... | Density: ...`` and a creative art prompt; a failed
    analysis reports ``Failed: Could not analyze audio. <error>`` and tags
    ``Analysis Error: <error>``). MP3 export and art generation are not
    ported yet: each reports ``Warning: ... not available in ame_tpu_torch
    yet`` (ROADMAP.md).

Input is staged as int16 where the file is PCM16 (half the upload bytes)
and converted on the device; the master is quantized to int16 on the device
and fetched as int16 for 16-bit WAV/AIFF output.
"""

from __future__ import annotations

import logging
import math
import os
import traceback
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ame_tpu_torch.config import COMPAT_CHUNK_SECONDS, MasterSettings

log = logging.getLogger("ame_tpu_torch")


def _noop(*a, **k):
    pass


def _not_ported(what: str) -> str:
    return f"Warning: {what} not available in ame_tpu_torch yet."


def master_file(input_file: str, output_file: str,
                settings: MasterSettings | Mapping[str, Any] | None = None,
                status_callback: Callable[[str], None] = _noop,
                progress_callback: Callable[[int, int], None] = _noop,
                device: str | torch.device = "cuda") -> dict:
    """Master one file: decode -> device graph -> encode.

    Returns an info dict: output path, sample_rate, n_samples and the
    loudness stats (when normalization ran)."""
    from ame_tpu_torch.io import read_audio

    status_callback("Loading audio into device memory...")
    audio, sr = read_audio(input_file, prefer_int16=True)
    return master_array(audio, sr, output_file, settings, status_callback,
                        progress_callback, device=device)


def master_array(audio: np.ndarray, sr: int, output_file: str,
                 settings: MasterSettings | Mapping[str, Any] | None = None,
                 status_callback: Callable[[str], None] = _noop,
                 progress_callback: Callable[[int, int], None] = _noop,
                 device: str | torch.device = "cuda") -> dict:
    """Master already-decoded audio [N, C]: float (any float dtype) or raw
    int16 samples, which are converted on the device (k/32768 is exact, so
    this equals the host float conversion). Other integer types are
    rejected: their scale is not the int16 one."""
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io import force_stereo, write_audio
    from ame_tpu_torch.ops.quantize import float_to_int16, int16_roundtrip

    if settings is None:
        settings = MasterSettings()
    elif isinstance(settings, Mapping):
        settings = MasterSettings.from_dict(settings)
    audio = np.asarray(audio)
    if audio.dtype.kind in "iu" and audio.dtype != np.int16:
        raise TypeError(f"integer audio must be int16 samples, got "
                        f"{audio.dtype}; convert to float in [-1, 1) first")
    device = torch.device(device)

    audio = force_stereo(audio)
    n = audio.shape[0]
    num_chunks = max(int(math.ceil(n / (COMPAT_CHUNK_SECONDS * sr))), 1)
    total_steps = num_chunks + 4
    # the reference's progress unit is (step, num_chunks + 4) from the very
    # first emission (engine:184-187) — never a different denominator
    progress_callback(0, total_steps)

    staged = torch.from_numpy(np.ascontiguousarray(audio)).to(device)
    if audio.dtype == np.int16:
        x = staged.to(torch.float32) * (1.0 / 32768.0)
    else:
        x = staged.to(torch.float32)
    if settings.mode == "compat":
        # engine:190-191: compat also forces the int16 grid
        # (set_sample_width(2) semantics)
        x = int16_roundtrip(x)

    status_callback("Running mastering graph on device...")
    progress_callback(1, total_steps)
    y, info = master_graph(x, sr, settings)
    progress_callback(num_chunks + 3, total_steps)

    status_callback("Exporting master...")
    ext = os.path.splitext(output_file)[1].lower()
    if settings.bits == 16 and ext in (".wav", ".wave", ".aif", ".aiff"):
        pcm = float_to_int16(y).to(torch.int16).cpu().numpy()
        write_audio(output_file, pcm, sr, bits=16)
    else:
        write_audio(output_file, y.cpu().numpy(), sr, bits=settings.bits)
    progress_callback(total_steps, total_steps)

    out = {"output_file": output_file, "sample_rate": sr, "n_samples": n}
    out.update({k: float(v) for k, v in info.items()})
    return out


def process_audio(settings: Mapping[str, Any],
                  status_callback: Callable[[str], None],
                  progress_callback: Callable[[int, int], None],
                  art_callback: Callable[[str | None], None],
                  tag_callback: Callable[[str], None],
                  device: str | torch.device = "cuda") -> None:
    """Reference-parity orchestrator: master, then the sidecars (MP3,
    analysis, art), with the degrade-and-continue error policy."""
    try:
        input_file = settings.get("input_file")
        output_file = settings.get("output_file")
        if not input_file or not output_file:
            raise ValueError("Input or output file not specified.")

        master_file(input_file, output_file, settings, status_callback,
                    progress_callback, device=device)

        if settings.get("create_mp3", False):
            status_callback(_not_ported("MP3 export"))

        status_callback("Mastering complete. Preparing for AI analysis...")
        manual_prompt = (settings.get("art_prompt") or "").strip()
        final_art_prompt = None
        if settings.get("auto_generate_prompt", False):
            status_callback("Analyzing audio with the Musicologist...")
            from ame_tpu_torch.analysis import musicologist
            tech_brief = musicologist.analyze_song(input_file,
                                                   device=device)
            if "error" in tech_brief:
                status_callback(
                    f"Failed: Could not analyze audio. {tech_brief['error']}")
                tag_callback(f"Analysis Error: {tech_brief['error']}")
            else:
                tag_callback(
                    f"Mood: {tech_brief['mood']}"
                    f" | Tempo: {tech_brief['tempo']}"
                    f" | Brightness: {tech_brief['brightness']}"
                    f" | Density: {tech_brief['density']}")
                status_callback("Building creative prompt from analysis...")
                from ame_tpu_torch.creative.prompts import (
                    generate_creative_prompt)
                final_art_prompt = generate_creative_prompt(tech_brief)
        elif manual_prompt:
            final_art_prompt = manual_prompt
            tag_callback("Using manual prompt.")
        if final_art_prompt:
            status_callback(_not_ported("AI art generation"))
        status_callback("Success: Processing complete! (No art generated)")
        art_callback(None)
    except Exception as e:
        log.error("fatal error in process_audio:\n%s", traceback.format_exc())
        status_callback(f"Error: {e}")
        progress_callback(0, 1)
        art_callback(None)
        tag_callback("Processing failed.")
