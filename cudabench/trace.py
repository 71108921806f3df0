"""The device trace of a traced run, reduced: ``torch.profiler`` over a
steady part of the window, read once the session has closed.

  * window: from the start of the first profiled ``bench.call`` range to
    the end of the last (the harness's range around each ``master_file``);
  * busy: the union of the device's activity intervals (kernels, copies,
    sets) inside the window;
  * device ops: device time by name;
  * idle gaps: the stretches of the window in which no device activity
    ran, each labelled with the innermost harness span open at its middle
    (``decode``, ``chain``, ``write``; ``call`` inside ``master_file`` but
    outside those three; ``none`` between calls).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

LABELS = ("decode", "chain", "write")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: list            # call indices profiled
    device_ops: dict       # name -> seconds
    gaps: list             # the TOP longest (label, seconds), longest first

    def device_seconds(self, names) -> float:
        """Device seconds of the ops whose names contain one of ``names``."""
        return sum(s for op, s in self.device_ops.items()
                   if any(n in op for n in names))


def _is_device(evt) -> bool:
    """A device activity: not a host event, and not the device-side copy of
    a ``record_function`` range (a user annotation on the device's
    timeline)."""
    return (evt.device_type != torch.autograd.DeviceType.CPU
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith("bench."))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(t, host):
    best, best_len = "none", float("inf")
    for name, a, b in host:
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


def reduce(events, calls) -> Trace:
    """``events``: ``prof.events()``; ``calls``: the call indices that ran
    inside the session. Times in the events are microseconds."""
    host, call_ranges, device = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            device.append((e.name, a, b))
        elif e.name == "bench.call":
            call_ranges.append((a, b))
        elif e.name.startswith("bench.") and e.name[6:] in LABELS:
            host.append((e.name[6:], a, b))
    if not call_ranges:
        return Trace(0.0, 0.0, list(calls), {}, [])
    w0 = min(a for a, _ in call_ranges)
    w1 = max(b for _, b in call_ranges)
    host += [("call", a, b) for a, b in call_ranges]
    ops = collections.Counter()
    inside = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops[name] += (b - a) * 1e-6
            inside.append((a, b))
    busy = _merge(inside)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = [(_label((a + b) / 2, host), (b - a) * 1e-6)
            for a, b in gaps[:TOP]]
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 calls=list(calls), device_ops=dict(ops), gaps=gaps)
