#!/usr/bin/env python3
"""The program's own spans in a traced run of a cell.

The port records spans inside ``api.master_file`` while its tracing is on
(``ame_tpu_torch.utils.telemetry``: ``tracing()``, ``records()``): one
``api.master`` root a call, ``io.decode``, ``api.upload``, ``chain`` with a
child a stage, ``api.fetch`` and ``io.write`` under it, each with its host
times on ``time.perf_counter`` (the harness's clock), the thread's minor
page faults, and, for the chain's stages on a card, CUDA-event times.
While a ``torch.profiler`` session is active each span is also a range
``ame.<name>`` in the device trace. This module reads them:

  * ``METRICS``: the per-layer metrics read from the spans, in
    ``BENCHMARK.json``'s form; their readers are ``metrics/<name>.py``,
    which take the spans whose root opens inside one of the window's
    ``call`` spans (set-up's for ``api.setup_ms``), and read nothing where
    the program records no spans;
  * ``idle_by_span``: the profiled window's device idle time, split by the
    innermost ``ame.*`` range open at each idle instant (``none`` outside
    every range);
  * a runner, ``python3 cudabench/program_trace.py`` with ``run.py``'s
    arguments: one run of the cell as ``run.py`` makes it, with the
    program's tracing on in a traced run (set-up's warm masters included)
    and ``METRICS`` reported beside the cell's per-layer metrics. Before
    the result line it prints ``{"idle_by_span": {...}}`` (seconds),
    ``{"program_ranges": {...}}`` (the ``ame.*`` ranges the profiler
    recorded on the host and on the device's timeline) and
    ``{"call_split": {...}}`` (a window call's mean ms and faults by span,
    and the loop's time between calls). An untraced run leaves tracing
    off.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":      # the checkout, in place of this directory
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from cudabench.spec import Spec  # noqa: E402

CELL = "quality_flagship_nolufs.album_dynamic"
_PER_CALL = "audio_x_realtime"


def _metric(name, unit, source, layer, moves=_PER_CALL):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": [CELL]}


METRICS = [
    _metric("api.upload_ms", "ms", "program_span", "api"),
    _metric("api.fetch_ms", "ms", "program_span", "api"),
    _metric("api.self_ms", "ms", "program_span", "api"),
    _metric("api.call_faults", "faults", "program_counter", "api"),
    _metric("io.decode_faults", "faults", "program_counter", "io"),
    _metric("io.write_faults", "faults", "program_counter", "io"),
    _metric("chain.device_ms", "ms", "program_span", "graph"),
    _metric("api.setup_ms", "ms", "program_span", "api", moves="setup_s"),
]


# -- the spans, read by the metric readers ----------------------------------

def spans() -> list:
    """The program's recorded spans; [] where the program records none
    (tracing was off, or a program without a recorder)."""
    try:
        from ame_tpu_torch.utils import telemetry
    except ImportError:
        return []
    records = getattr(telemetry, "records", None)
    return list(records()) if records is not None else []


def _calls(run) -> list[tuple[float, float]]:
    return [(t0, t1) for name, _, t0, t1 in run.spans if name == "call"]


def window_calls(run) -> list[list]:
    """One list of spans a window call: the spans of every track whose
    root opens inside the call's harness span."""
    calls = sorted(_calls(run))
    if not calls:
        return []
    by_track: dict = {}
    for s in spans():
        by_track.setdefault(s.track, []).append(s)
    out = [[] for _ in calls]
    for track in by_track.values():
        root = next((s for s in track if s.id == s.track), None)
        if root is None:
            continue
        for i, (t0, t1) in enumerate(calls):
            if t0 <= root.t0 <= t1:
                out[i] += track
                break
    return [c for c in out if c]


def _mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def mean_ms(run, name: str) -> float | None:
    """Mean host ms a window call spends in spans named ``name``."""
    return _mean(sum((s.t1 - s.t0) * 1e3 for s in c if s.name == name)
                 for c in window_calls(run))


def mean_faults(run, name: str) -> float | None:
    """Mean minor page faults a window call in spans named ``name``."""
    return _mean(sum(s.faults for s in c if s.name == name)
                 for c in window_calls(run))


def self_ms(run, name: str = "api.master") -> float | None:
    """Mean host ms a window call spends in ``name`` outside its direct
    child spans (one thread's children never overlap)."""
    def one(call):
        total = 0.0
        for root in (s for s in call if s.name == name):
            kids = sum(s.t1 - s.t0 for s in call if s.parent == root.id)
            total += (root.t1 - root.t0 - kids) * 1e3
        return total
    return _mean(one(c) for c in window_calls(run))


def device_ms(run) -> float | None:
    """Mean device ms a window call from its first chain stage's start
    event to its last stage's end event; None without device times."""
    def one(call):
        st = [s for s in call if s.name.startswith("chain.")
              and s.dev_t0 is not None]
        return (max(s.dev_t1 for s in st) - min(s.dev_t0 for s in st)
                if st else None)
    return _mean(v for v in map(one, window_calls(run)) if v is not None)


def setup_ms(run) -> float | None:
    """Host ms of set-up's ``api.master`` spans (those that open before the
    window's first call), less the ``ops.build`` spans inside them."""
    calls = _calls(run)
    if not calls:
        return None
    w0 = min(t0 for t0, _ in calls)
    all_spans = spans()
    roots = {s.id: s for s in all_spans
             if s.name == "api.master" and s.parent is None and s.t0 < w0}
    if not roots:
        return None
    builds = sum(s.t1 - s.t0 for s in all_spans
                 if s.name == "ops.build" and s.track in roots
                 and s.parent is not None)
    return (sum(s.t1 - s.t0 for s in roots.values()) - builds) * 1e3


def call_split(run) -> dict:
    """A window call's mean host ms and faults by span name, the harness's
    spans beside them, and the loop's ms between calls (the FIFO drain)."""
    calls = window_calls(run)
    names = sorted({s.name for c in calls for s in c})
    out = {"calls": len(calls),
           "ms": {n: mean_ms(run, n) for n in names},
           "faults": {n: mean_faults(run, n) for n in names},
           "self_ms": {"api.master": self_ms(run)},
           "harness_ms": {}}
    for name in ("call", "decode", "write", "chain"):
        hs = [(t1 - t0) * 1e3 for n, _, t0, t1 in run.spans if n == name]
        out["harness_ms"][name] = (sum(hs) / len(run.calls)
                                   if run.calls and hs else None)
    if run.calls:
        out["loop_ms"] = (run.window_s * 1e3 / len(run.calls)
                          - sum(c.ms for c in run.calls) / len(run.calls))
    return out


# -- the device trace ---------------------------------------------------------

def _host(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CPU


def idle_by_span(events) -> dict:
    """Seconds of the window (the ``bench.call`` ranges' extent, as
    ``trace.reduce`` takes it) in which no device activity ran, by the
    innermost host ``ame.*`` range open then; ``none`` outside every
    range. The values sum to the window less its busy time."""
    from cudabench import trace

    host, calls, device = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("ame."):
            if _host(e):
                host.append((a, b, e.name[4:]))
        elif trace._is_device(e):
            device.append((a, b))
        elif e.name == "bench.call":
            calls.append((a, b))
    if not calls:
        return {}
    w0, w1 = min(a for a, _ in calls), max(b for _, b in calls)
    busy = trace._merge([(max(a, w0), min(b, w1)) for a, b in device
                         if min(b, w1) > max(a, w0)])
    idle, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    # the window cut at every range boundary, each piece labelled with the
    # shortest range that covers it
    cuts = sorted({w0, w1} | {p for a, b, _ in host for p in (a, b)
                              if w0 < p < w1})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        over = [(rb - ra, name) for ra, rb, name in host
                if ra <= a and b <= rb]
        pieces.append((a, b, min(over)[1] if over else "none"))
    out: dict = {}
    i = 0
    for a, b in idle:
        while pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            out[name] = out.get(name, 0.0) + (min(b, pb) - max(a, pa)) * 1e-6
            j += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def program_ranges(events) -> dict:
    """The ``ame.*`` ranges the profiler holds: on the host, and copies on
    the device's timeline (annotations, not device work)."""
    host = sum(1 for e in events if e.name.startswith("ame.") and _host(e))
    dev = sum(1 for e in events if e.name.startswith("ame.") and not _host(e))
    return {"host": host, "device_copies": dev}


# -- the runner ---------------------------------------------------------------

class _ProgramSpec(Spec):
    """The benchmark's spec, with ``METRICS`` among a cell's per-layer
    metrics; keeps the run its readers read."""

    run = None

    def per_layer(self, cell):
        return super().per_layer(cell) + [m for m in METRICS
                                          if cell in m["workloads"]]

    def reader(self, metric):
        module, spec = super().reader(metric), self

        class Reader:
            @staticmethod
            def read(run):
                spec.run = run
                return module.read(run)
        return Reader


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", spec: Spec | None = None,
        mix: dict | None = None, out=None, err=None) -> int:
    """``harness.run`` with the program's tracing on where ``trace``;
    prints the harness's lines, this module's lines, then the result."""
    from ame_tpu_torch.utils import telemetry
    from cudabench import harness
    from cudabench import trace as trace_mod

    out = out or sys.stdout
    spec = _ProgramSpec(spec.dir) if spec is not None else _ProgramSpec()
    if not trace:
        return harness.run(workload, seed, seconds, False, t_start=t_start,
                           device=device, spec=spec, mix=mix, out=out,
                           err=err)
    lines = io.StringIO()
    extra = []
    reduce = trace_mod.reduce

    def reduce_with_program(events, calls):
        events = list(events)
        extra.append({"program_ranges": program_ranges(events)})
        # the ranges' device-side copies are annotations, not device work
        events = [e for e in events if _host(e)
                  or not e.name.startswith("ame.")]
        extra.append({"idle_by_span": idle_by_span(events)})
        return reduce(events, calls)

    trace_mod.reduce = reduce_with_program
    try:
        with telemetry.tracing():
            rc = harness.run(workload, seed, seconds, True, t_start=t_start,
                             device=device, spec=spec, mix=mix, out=lines,
                             err=err)
    finally:
        trace_mod.reduce = reduce
    got = lines.getvalue().splitlines()
    for line in got[:-1] if rc == 0 else got:
        print(line, file=out)
    if rc == 0:
        if spec.run is not None:
            extra.append({"call_split": call_split(spec.run)})
        for e in extra:
            print(json.dumps(e), file=out)
        print(got[-1], file=out)
    out.flush()
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from cudabench.run import _environment
    _environment()
    return run(a.workload, a.seed, a.seconds, bool(a.trace),
               t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
