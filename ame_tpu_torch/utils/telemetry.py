"""Memory and timing telemetry (port of ``ame_tpu/utils/telemetry.py``;
SURVEY.md §5.1).

The reference's observability is timestamped function-scoped logging plus
psutil RSS samples at pipeline milestones (audio_mastering_engine.py:30,
247-249). Equivalents here:

  * ``log_memory_usage(stage)`` — host RSS plus, per CUDA card this
    process uses, the bytes PyTorch's allocator holds and its peak, and the
    card's free / total memory;
  * ``stage_timer`` — wall-clock spans around pipeline milestones;
  * ``profile_trace`` — a ``torch.profiler`` span written as a Chrome trace.

Telemetry never creates a CUDA context: on a process that has not touched
a card, ``device_memory_stats`` reports nothing for it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time

import torch

log = logging.getLogger("ame_tpu_torch.telemetry")

# cards whose caching allocator was seen holding memory (see _cards_in_use)
_seen_cards: set[int] = set()


def host_rss_mb() -> float | None:
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1024 ** 2
    except (OSError, ValueError, IndexError):
        return None


def _cards_in_use() -> list[int]:
    """The cards whose caching allocator holds memory now or did at an
    earlier call. A segment of the allocator on card i was made by
    ``cudaMalloc`` there, so card i already has its context; the snapshot
    reads the allocator's host-side records and touches no card. Asking a
    card for its memory (``mem_get_info``) would create a context on it, so
    no other card is asked."""
    for seg in torch.cuda.memory_snapshot():
        _seen_cards.add(int(seg["device"]))
    return sorted(_seen_cards)


def device_memory_stats() -> list[dict]:
    """One dict a CUDA card in use: {"device", "bytes_in_use",
    "peak_bytes_in_use", "free_bytes", "total_bytes"}; [] when CUDA is
    unavailable or not initialized in this process."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    out = []
    for i in _cards_in_use():
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
    if not log.isEnabledFor(logging.INFO):
        return
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


@contextlib.contextmanager
def profile_trace(logdir: str | None = None):
    """``torch.profiler`` span over the host and, where there is one, the
    card; on exit the trace is written to ``logdir`` (default: a directory
    under the temp dir) as ``trace_<pid>.json``, a Chrome trace
    (chrome://tracing, Perfetto). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "ame_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))
