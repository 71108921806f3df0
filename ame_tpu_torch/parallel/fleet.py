"""Fleet mastering with a checkpointed manifest (SURVEY.md §5.4).

Port of ``ame_tpu/parallel/fleet.py``. The reference has no checkpoint /
resume — per-chunk temp WAVs die with their TemporaryDirectory and jobs
restart from scratch. For fleet mastering (a directory of tracks) this
runner keeps a JSON manifest beside the output directory recording each
track's state (pending | done | error), fsynced and renamed into place
after every track — an interrupted fleet resumes exactly where it stopped.

Single-process, device-serial by design: the card's chain is a few ms of
a track's file-to-file time, so the fleet's bottleneck is host IO; the
native prefetch loader (``io/loader.py``) decodes the next tracks while
the card masters this one. For several cards, give each its own directory
and manifest.
"""

from __future__ import annotations

import json
import logging
import os
import time

from ame_tpu_torch.device import resolve_device

log = logging.getLogger("ame_tpu_torch.fleet")

AUDIO_EXTS = (".wav", ".wave", ".mp3", ".flac", ".aif", ".aiff", ".aifc")


class Manifest:
    def __init__(self, path: str):
        self.path = path
        self.state: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                self.state = json.load(f)

    def status(self, track: str) -> str:
        return self.state.get(track, {}).get("status", "pending")

    def mark(self, track: str, status: str, **extra) -> None:
        self.state[track] = {"status": status, "time": time.time(), **extra}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


def run_fleet(input_dir: str, output_dir: str, settings: dict,
              manifest_path: str | None = None,
              status_callback=lambda m: None, device="cuda") -> dict:
    """Master every audio file under input_dir into output_dir
    (``<stem>_mastered.wav``) on ``device``, resuming from the manifest. A
    track that fails to decode or master is marked ``error`` and the run
    goes on; it is retried on the next run. Returns summary counts."""
    from ame_tpu_torch.api import master_array
    from ame_tpu_torch.io.loader import PrefetchLoader

    dev = resolve_device(device, "the fleet")
    os.makedirs(output_dir, exist_ok=True)
    manifest = Manifest(manifest_path
                        or os.path.join(output_dir, "fleet_manifest.json"))

    tracks = sorted(
        f for f in os.listdir(input_dir)
        if os.path.splitext(f)[1].lower() in AUDIO_EXTS)
    todo = [n for n in tracks if manifest.status(n) != "done"]
    skipped = len(tracks) - len(todo)
    done = failed = 0
    # the native loader decodes upcoming tracks on C++ worker threads
    # while the device masters the current one (io/loader.py)
    with PrefetchLoader([os.path.join(input_dir, n) for n in todo],
                        workers=int(os.environ.get(
                            "AME_TPU_FLEET_DECODERS", 4))) as loader:
        for name, (src, audio, sr) in zip(todo, loader):
            dst = os.path.join(
                output_dir, os.path.splitext(name)[0] + "_mastered.wav")
            status_callback(f"Mastering {name}...")
            try:
                if audio is None:   # decode failed; sr holds the exception
                    raise sr
                info = master_array(audio, sr, dst, dict(settings),
                                    device=dev)
                manifest.mark(name, "done", output=dst,
                              output_i=info.get("output_i"))
                done += 1
            except Exception as e:  # noqa: BLE001 — one track, recorded
                log.exception("fleet: %s failed", name)
                manifest.mark(name, "error", error=str(e))
                failed += 1
    summary = {"total": len(tracks), "done": done, "resumed_skips": skipped,
               "failed": failed, "manifest": manifest.path}
    status_callback(f"Fleet complete: {summary}")
    return summary
