"""The kernel wrappers' launch counters.

Each counter is a plain int attribute of its wrapper (``sosfilt_cuda
.launches``, ``gain_p1_cuda.reset_launches``, ...), which a caller zeroes
and reads as it likes. ``bump`` adds to one under a lock, so that wrappers
called from several threads at once (a server's workers, two callers of
``master_graph_fused``) lose no count."""

from __future__ import annotations

import threading

_lock = threading.Lock()


def bump(fn, attr: str = "launches", n: int = 1) -> None:
    """``fn.<attr> += n``, atomically with respect to every other bump."""
    with _lock:
        setattr(fn, attr, getattr(fn, attr) + n)
