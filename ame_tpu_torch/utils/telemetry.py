"""Memory and timing telemetry (port of ``ame_tpu/utils/telemetry.py``;
SURVEY.md §5.1).

The reference's observability is timestamped function-scoped logging plus
psutil RSS samples at pipeline milestones (audio_mastering_engine.py:30,
247-249). Equivalents here:

  * ``log_memory_usage(stage)`` — host RSS plus, per CUDA card, the bytes
    PyTorch's allocator holds and its peak, and the card's free / total
    memory;
  * ``stage_timer`` — wall-clock spans around pipeline milestones.

Telemetry never initializes CUDA: on a process that has not touched the
card, ``device_memory_stats`` reports nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("ame_tpu_torch.telemetry")


def host_rss_mb() -> float | None:
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1024 ** 2
    except (OSError, ValueError, IndexError):
        return None


def device_memory_stats() -> list[dict]:
    """One dict a CUDA card: {"device", "bytes_in_use",
    "peak_bytes_in_use", "free_bytes", "total_bytes"}; [] when CUDA is
    unavailable or not initialized in this process."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current",
                                              0),
                    "peak_bytes_in_use": stats.get(
                        "allocated_bytes.all.peak", 0),
                    "free_bytes": free, "total_bytes": total})
    return out


def log_memory_usage(stage: str = "") -> None:
    """Milestone memory log (the reference's log_memory_usage, engine:
    247-249, extended with the cards' memory)."""
    rss = host_rss_mb()
    if rss is not None:
        log.info("MEMORY USAGE at '%s': %.2f MB RSS", stage, rss)
    for s in device_memory_stats():
        log.info("  %s: %.1f MB allocated (peak %.1f MB), %.1f of %.1f MB "
                 "free", s["device"], s["bytes_in_use"] / 1024 ** 2,
                 s["peak_bytes_in_use"] / 1024 ** 2,
                 s["free_bytes"] / 1024 ** 2, s["total_bytes"] / 1024 ** 2)


@contextlib.contextmanager
def stage_timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("stage '%s' took %.1f ms", name,
                 (time.perf_counter() - t0) * 1000)
