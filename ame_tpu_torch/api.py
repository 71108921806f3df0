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
    fatal. The MP3 is LAME V0 beside the WAV (``export_mp3_sidecar``; a
    failure is reported, never raised). The analysis runs on ``device``
    (``auto_generate_prompt``: the Musicologist's brief becomes the tag
    line ``Mood: ... | Tempo: ... | Brightness: ... | Density: ...`` and a
    creative art prompt; a failed analysis reports ``Failed: Could not
    analyze audio. <error>`` and tags ``Analysis Error: <error>``). Art
    goes through ``creative/art.py``'s active provider, where one is
    available, to ``<master-stem>_art.png``.

``shard_time`` masters one track over every card
(``_master_shard_time``: ``parallel/sp_master.master_sequence_parallel_padded``
on a mesh of every ``cuda:i``, capped by ``AME_TPU_SP_DEVICES``; with
``device="cpu"`` the mesh is the CPU once), one such job at a time in a
process. The degrade policy is the reference's: a malformed cap raises
``SpConfigError``; any other failure of the sharded chain (a track it
cannot take, such as compat loudnorm under 3.1 s) emits ``Warning:
time-sharding unavailable (...); falling back to one device.`` and masters
on ``device``. Memory is logged at the reference's milestones
(``utils/telemetry.log_memory_usage``).

Input is staged as int16 where the file is PCM16 (half the upload bytes)
and converted on the device; the master is quantized to int16 on the device
and fetched as int16 for 16-bit WAV/AIFF output. On a card both copies go
through this thread's reused page-locked blocks (``io/staging``): the
decode of a PCM16 WAV in ``master_file`` reads into one and the upload
from it does not block; the int16 fetch copies into the other, which the
encoder writes from. Other arrays upload from pageable memory.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import traceback
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ame_tpu_torch.config import COMPAT_CHUNK_SECONDS, MasterSettings
from ame_tpu_torch.utils.telemetry import log_memory_usage, stage_timer

log = logging.getLogger("ame_tpu_torch")


def _noop(*a, **k):
    pass


def master_file(input_file: str, output_file: str,
                settings: MasterSettings | Mapping[str, Any] | None = None,
                status_callback: Callable[[str], None] = _noop,
                progress_callback: Callable[[int, int], None] = _noop,
                device: str | torch.device = "cuda",
                shard_time: bool = False) -> dict:
    """Master one file: decode -> device graph -> encode.

    ``shard_time``: master over every card (see the module docstring).

    Returns an info dict: output path, sample_rate, n_samples and the
    loudness stats (when normalization ran)."""
    with stage_timer("api.master"):
        return _master_file(input_file, output_file, settings,
                            status_callback, progress_callback, device,
                            shard_time)


def _master_file(input_file, output_file, settings, status_callback,
                 progress_callback, device, shard_time) -> dict:
    from ame_tpu_torch.io import read_audio, staging

    status_callback("Loading audio into device memory...")
    # a PCM16 WAV is read straight into this thread's page-locked block,
    # which _master_array recognizes and uploads from
    with staging.decoding_into(staging.pool(torch.device(device))):
        audio, sr = read_audio(input_file, prefer_int16=True)
    return _master_array(audio, sr, output_file, settings, status_callback,
                         progress_callback, device, shard_time)


def master_array(audio: np.ndarray, sr: int, output_file: str,
                 settings: MasterSettings | Mapping[str, Any] | None = None,
                 status_callback: Callable[[str], None] = _noop,
                 progress_callback: Callable[[int, int], None] = _noop,
                 device: str | torch.device = "cuda",
                 shard_time: bool = False) -> dict:
    """Master already-decoded audio [N, C]: float (any float dtype) or raw
    int16 samples, which are converted on the device (k/32768 is exact, so
    this equals the host float conversion). Other integer types are
    rejected: their scale is not the int16 one."""
    with stage_timer("api.master"):
        return _master_array(audio, sr, output_file, settings,
                             status_callback, progress_callback, device,
                             shard_time)


def _master_array(audio, sr, output_file, settings, status_callback,
                  progress_callback, device, shard_time) -> dict:
    """``master_array`` inside the caller's ``api.master`` span, which
    closes after this returns, so that it covers the release of the
    call's host and device buffers (the locals here)."""
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io import force_stereo, staging, write_audio
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

    log_memory_usage("Pipeline Start")
    log_memory_usage("After Decode")
    audio = force_stereo(audio)
    n = audio.shape[0]
    num_chunks = max(int(math.ceil(n / (COMPAT_CHUNK_SECONDS * sr))), 1)
    total_steps = num_chunks + 4
    # the reference's progress unit is (step, num_chunks + 4) from the very
    # first emission (engine:184-187) — never a different denominator
    progress_callback(0, total_steps)

    pool = staging.pool(device)
    with stage_timer("api.upload"):
        staged = pool.upload(audio, device) if pool is not None else None
        if staged is None:
            staged = torch.from_numpy(np.ascontiguousarray(audio)).to(device)
        if audio.dtype == np.int16:
            x = staged.to(torch.float32) * (1.0 / 32768.0)
        else:
            x = staged.to(torch.float32)
    if settings.mode == "compat":
        # engine:190-191: compat also forces the int16 grid
        # (set_sample_width(2) semantics)
        x = int16_roundtrip(x)

    if shard_time:
        try:
            y, info = _master_shard_time(x, sr, settings, status_callback,
                                         device)
        except SpConfigError:
            raise          # operator misconfiguration must fail loudly
        except Exception as e:
            # sp eligibility (track length, chunk alignment, mode) is
            # stricter than the one-device graph's; the job must still
            # master: degrade, don't fail
            log.exception("shard_time master failed; degrading")
            status_callback(f"Warning: time-sharding unavailable ({e}); "
                            f"falling back to one device.")
            shard_time = False
        else:
            progress_callback(1, total_steps)
    if not shard_time:
        status_callback("Running mastering graph on device...")
        progress_callback(1, total_steps)
        y, info = master_graph(x, sr, settings)
    progress_callback(num_chunks + 3, total_steps)
    log_memory_usage("After Graph")

    status_callback("Exporting master...")
    ext = os.path.splitext(output_file)[1].lower()
    int16_out = settings.bits == 16 and ext in (".wav", ".wave", ".aif",
                                                ".aiff")
    # the fetch waits for the chain's queued device work
    with stage_timer("api.fetch"):
        if int16_out:
            q = float_to_int16(y).to(torch.int16)
            pcm = pool.fetch(q) if pool is not None else q.cpu().numpy()
        else:
            pcm = y.cpu().numpy()
    write_audio(output_file, pcm, sr, bits=16 if int16_out else settings.bits)
    progress_callback(total_steps, total_steps)
    log_memory_usage("After Export")

    out = {"output_file": output_file, "sample_rate": sr, "n_samples": n}
    out.update({k: float(v) for k, v in info.items()})
    return out


class SpConfigError(Exception):
    """Operator misconfiguration of the sp pool: never swallowed by the
    shard_time degrade path (unlike a track the sharded chain cannot
    take)."""


_shard_time_lock = threading.Lock()


def _sp_devices(device: torch.device) -> list:
    """The sp pool: every card (``device`` on a card), capped by
    ``AME_TPU_SP_DEVICES`` (0 or unset: all), or the CPU once."""
    if device.type == "cpu":
        return [device]
    from ame_tpu_torch.device import resolve_device
    resolve_device(device, "time-sharded mastering")
    devs = [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]
    cap_env = os.environ.get("AME_TPU_SP_DEVICES", "0")
    try:
        cap = int(cap_env)
    except ValueError:
        raise SpConfigError(
            f"AME_TPU_SP_DEVICES must be an integer device count, got "
            f"{cap_env!r}") from None
    return devs[:cap] if cap > 0 else devs


def _master_shard_time(x: torch.Tensor, sr: int, settings: MasterSettings,
                       status_callback, device: torch.device):
    """One track over every device of the sp pool (the padded sp chain).
    A process lock serializes shard_time masters: two all-device jobs
    would only contend for the same cards. Returns (y on the pool's first
    device, info)."""
    from ame_tpu_torch.parallel.mesh import make_mesh
    from ame_tpu_torch.parallel.sp_master import (
        master_sequence_parallel_padded)

    devs = _sp_devices(device)
    status_callback(f"Running time-sharded mastering graph over "
                    f"{len(devs)} devices...")
    with _shard_time_lock:
        # the sp wrapper pads to its own shard / hop / chunk granule and
        # masks the measurement with the true length
        return master_sequence_parallel_padded(
            x, sr, settings, make_mesh({"sp": len(devs)}, devices=devs))


def export_mp3_sidecar(wav_path: str,
                       status_callback: Callable[[str], None]) -> None:
    """Best-effort MP3 export beside the WAV (engine:140-150 contract:
    failures are warnings, never fatal)."""
    if not wav_path or not os.path.exists(wav_path):
        log.warning("master WAV missing; skipping MP3")
        status_callback("Warning: Could not find master WAV to create MP3.")
        return
    mp3_path = os.path.splitext(wav_path)[0] + ".mp3"
    status_callback("Creating high-quality MP3...")
    try:
        from ame_tpu_torch.io import read_audio
        from ame_tpu_torch.io.codecs import encode_mp3
        audio, sr = read_audio(wav_path)
        encode_mp3(mp3_path, audio, sr, vbr_quality=0)
        status_callback("High-quality MP3 created successfully.")
    except Exception:
        log.exception("MP3 export failed")
        status_callback("Error: Failed to create MP3 file.")


def process_audio(settings: Mapping[str, Any],
                  status_callback: Callable[[str], None],
                  progress_callback: Callable[[int, int], None],
                  art_callback: Callable[[str | None], None],
                  tag_callback: Callable[[str], None],
                  device: str | torch.device = "cuda") -> None:
    """Reference-parity orchestrator: master -> MP3 -> analysis -> prompt ->
    art, with the degrade-and-continue error policy."""
    try:
        input_file = settings.get("input_file")
        output_file = settings.get("output_file")
        if not input_file or not output_file:
            raise ValueError("Input or output file not specified.")

        info = master_file(input_file, output_file, settings,
                           status_callback, progress_callback, device=device,
                           shard_time=bool(settings.get("shard_time",
                                                        False)))

        if settings.get("create_mp3", False):
            export_mp3_sidecar(info["output_file"], status_callback)

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

        from ame_tpu_torch.creative import art as art_mod
        if final_art_prompt and art_mod.available():
            status_callback("Starting AI art generation...")
            try:
                art_path = art_mod.generate_cover_art(final_art_prompt,
                                                      output_file)
                status_callback("Success: AI art generation complete!")
                art_callback(art_path)
            except Exception:
                log.exception("art generation failed")
                status_callback(
                    "Failed: Mastering complete, but AI art failed.")
                art_callback(None)
        else:
            status_callback("Success: Processing complete! (No art generated)")
            art_callback(None)
    except Exception as e:
        log.error("fatal error in process_audio:\n%s", traceback.format_exc())
        status_callback(f"Error: {e}")
        progress_callback(0, 1)
        art_callback(None)
        tag_callback("Processing failed.")
