"""Memory and timing telemetry (port of ``ame_tpu/utils/telemetry.py``;
SURVEY.md §5.1).

The reference's observability is timestamped function-scoped logging plus
psutil RSS samples at pipeline milestones (audio_mastering_engine.py:30,
247-249). Equivalents here:

  * ``log_memory_usage(stage)`` — host RSS plus, per CUDA card this
    process uses, the bytes PyTorch's allocator holds and its peak, and the
    card's free / total memory;
  * ``stage_timer`` — the program's span: a wall-clock span around a
    pipeline milestone, logged at INFO, and recorded while ``tracing()`` is
    on; given a CUDA device, its device work is also timed by an event
    pair;
  * ``tracing`` / ``records`` — the span recorder's switch and its records;
  * ``note_host_bytes`` — a count of fresh host bytes, in the open span;
  * ``profile_trace`` — a ``torch.profiler`` span written as a Chrome trace.

Tracing is off by default; a span site then costs a read of the module's
switch and the logger's ``isEnabledFor`` check. While ``tracing()`` is on,
each span is recorded in memory (a bounded deque, oldest out) with its
name, its start and end on ``time.perf_counter``, its parent span, its
track (the id of the root span of its thread's call, so concurrent
workers never mix), the thread's minor page faults over it
(``getrusage``) and the bytes of the sample-sized host arrays made in it
(``note_host_bytes``: the codecs count theirs). While a
``torch.profiler`` session is active too, each span is also a
``record_function`` range ``ame.<name>``, so that it sits in the device
trace on the profiler's clock; outside a session no range is entered
(one costs microseconds even with no profiler).

Telemetry never creates a CUDA context: on a process that has not touched
a card, ``device_memory_stats`` reports nothing for it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

try:
    import resource
except ImportError:      # no getrusage (Windows): spans count no faults
    resource = None

log = logging.getLogger("ame_tpu_torch.telemetry")

TRACE_RECORDS = 1 << 16   # spans a recorder keeps, oldest out
_INFO = logging.INFO
_RUSAGE = getattr(resource, "RUSAGE_THREAD",
                  getattr(resource, "RUSAGE_SELF", None))

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


class Span:
    """One recorded span. ``t0`` / ``t1``: ``time.perf_counter`` seconds;
    ``id``, ``parent`` (None for a root) and ``track`` (the root's id):
    span ids; ``thread``: the thread's ident; ``faults``: the thread's
    minor page faults over the span (the process's where the platform
    counts no thread's). ``dev_t0`` / ``dev_t1``: for a span timed with
    CUDA events (``event_pair``), its device start and end in ms on the
    recorder's device clock, resolved when the records are read; None
    otherwise. ``host_bytes``: the bytes of the sample-sized host arrays
    the thread allocated while the span was its innermost
    (``note_host_bytes``)."""

    __slots__ = ("name", "id", "parent", "track", "thread", "t0", "t1",
                 "faults", "host_bytes", "dev_t0", "dev_t1", "events")

    def __init__(self, name, id_, parent, track):
        self.name, self.id, self.parent, self.track = name, id_, parent, track
        self.thread = threading.get_ident()
        self.t0 = self.t1 = 0.0
        self.faults = self.host_bytes = 0
        self.dev_t0 = self.dev_t1 = self.events = None


class Recorder:
    """The spans of one ``tracing()`` extent, in the order they closed."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(
            maxlen=TRACE_RECORDS)
        # spans whose device events are unread, as bounded
        self._pending: collections.deque = collections.deque(
            maxlen=TRACE_RECORDS)
        self._refs: dict = {}        # device -> its clock's reference event
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        self.spans.append(span)
        if span.events is not None:
            with self._lock:
                self._pending.append(span)

    def reference(self, device: torch.device):
        """The event that starts ``device``'s clock, recorded on the
        device's current stream at its first use."""
        with self._lock:
            ref = self._refs.get(device)
            if ref is None:
                ref = torch.cuda.Event(enable_timing=True)
                ref.record(torch.cuda.current_stream(device))
                self._refs[device] = ref
            return ref

    def records(self) -> list[Span]:
        """The spans, with every device time resolved: this waits for the
        device work the spans' events bracket."""
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for s in pending:
            ref, start, end = s.events
            end.synchronize()
            s.dev_t0, s.dev_t1 = ref.elapsed_time(start), ref.elapsed_time(end)
            s.events = None
        return list(self.spans)


_switch = threading.Lock()        # guards the three below
_depth = 0                        # open tracing() extents
_on = False                       # the switch every span site reads
_recorder: Recorder | None = None  # the current extent's, else the last's
_ids = itertools.count(1)
_local = threading.local()        # .stack: the thread's open spans


def _minor_faults() -> int:
    return resource.getrusage(_RUSAGE).ru_minflt if resource else 0


class _Off:
    """A span site while tracing is off and INFO is not logged."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Logged:
    """A span site while tracing is off: the host time, logged."""

    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        log.info("stage '%s' took %.1f ms", self.name,
                 (time.perf_counter() - self.t0) * 1000)
        return False


class _Recorded:
    """A span site while tracing is on: the span, recorded on exit."""

    __slots__ = ("name", "recorder", "span", "range")

    def __init__(self, name, recorder):
        self.name, self.recorder, self.range = name, recorder, None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        id_ = next(_ids)
        parent = stack[-1] if stack else None
        s = self.span = Span(self.name, id_, parent and parent.id,
                             parent.track if parent else id_)
        stack.append(s)
        s.faults = _minor_faults()
        s.t0 = time.perf_counter()
        # inside the span: the range's own cost under a profiler (up to ms
        # on a session's first ranges) is the span's, as the range's is
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function("ame." + s.name)
            self.range.__enter__()
        return s

    def __exit__(self, *exc):
        s = self.span
        if self.range is not None:
            self.range.__exit__(*exc)
        s.t1 = time.perf_counter()
        s.faults = _minor_faults() - s.faults
        _local.stack.pop()
        self.recorder.add(s)
        if log.isEnabledFor(logging.INFO):
            log.info("stage '%s' took %.1f ms", s.name, (s.t1 - s.t0) * 1000)
        return False


class _Timed(_Recorded):
    """A recorded span whose device work on a CUDA device is bracketed by
    an ``event_pair``; under a stream capture it records no event, which
    the captured graph would hold."""

    __slots__ = ("device", "end")

    def __init__(self, name, recorder, device):
        super().__init__(name, recorder)
        self.device, self.end = device, None

    def __enter__(self):
        s = super().__enter__()
        if not torch.cuda.is_current_stream_capturing():
            start, self.end = event_pair(s, self.device)
            start.record()
        return s

    def __exit__(self, *exc):
        if self.end is not None:
            self.end.record()
        return super().__exit__(*exc)


def stage_timer(name: str, device: torch.device | None = None):
    """The program's span around a pipeline milestone ``name``: a context
    manager that yields the ``Span`` it records while ``tracing()`` is on,
    and None otherwise. Its host time is logged at INFO either way. On a
    CUDA ``device`` a recorded span also gets its device times
    (``dev_t0`` / ``dev_t1``) from a pair of events around its work, with
    no sync; nothing is recorded while tracing is off."""
    if _on:
        if device is not None and device.type == "cuda":
            return _Timed(name, _recorder, device)
        return _Recorded(name, _recorder)
    if log.isEnabledFor(_INFO):
        return _Logged(name)
    return _OFF


def note_host_bytes(n: int) -> None:
    """Count ``n`` bytes of host memory a sample-sized array takes, in the
    calling thread's innermost open span, while ``tracing()`` is on; off,
    a read of the module's switch."""
    if _on:
        stack = getattr(_local, "stack", None)
        if stack:
            stack[-1].host_bytes += n


def event_pair(span: Span | None, device: torch.device):
    """Two timing CUDA events (start, end) on ``device``. Where ``span`` is
    a recorded span, its ``dev_t0`` / ``dev_t1`` are read from them when
    the records are read: record ``start`` before the span's device work
    and ``end`` after it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if span is not None and _recorder is not None:
        span.events = (_recorder.reference(device), start, end)
    return start, end


@contextlib.contextmanager
def tracing():
    """Record the program's spans for the extent of the block; yields the
    ``Recorder``. Extents nest (an inner one shares the outer's recorder);
    recording stops when the outermost closes, and its spans stay readable
    (``records()``) until the next extent opens."""
    global _depth, _on, _recorder
    with _switch:
        if _depth == 0:
            _recorder = Recorder()
        _depth += 1
        _on = True
        recorder = _recorder
    try:
        yield recorder
    finally:
        with _switch:
            _depth -= 1
            _on = _depth > 0


def records() -> list[Span]:
    """The spans of the current ``tracing()`` extent, or of the last one;
    [] before any."""
    return _recorder.records() if _recorder is not None else []


@contextlib.contextmanager
def profile_trace(logdir: str | None = None):
    """``torch.profiler`` span over the host and, where there is one, the
    card; on exit the trace is written to ``logdir`` (default: a directory
    under the temp dir) as ``trace_<pid>.json``, a Chrome trace
    (chrome://tracing, Perfetto). Tracing is on inside it, so the trace
    carries the program's spans as ``ame.<name>`` ranges (the chain's
    stages as ``ame.chain.<stage>``). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "ame_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing(), profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))
