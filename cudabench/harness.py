"""One run of one cell: set-up, the timed window, the traced part, the
check against the plain reference, and the result line.

Closed loop, one caller: a mastering service draining its queue with one
worker a card. The window starts at the first timed call of
``ame_tpu_torch.api.master_file`` and ends when the last call that started
before ``seconds`` elapsed returns; the next call starts when the previous
one has returned and its master has been drained from the FIFO.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from cudabench import peaks as peak_table
from cudabench import traffic
from cudabench.reference import wav
from cudabench.sink import FifoSink
from cudabench.spans import Spans
from cudabench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ame_tpu")
CHECK_TRACKS = 4          # masters compared a run, unless the mix says
SPAN = 0.9                # sampled calls start before this share of it
LATE = 0.75               # the longest track's sampled call starts after
PROFILE_MIN_S = 2.0       # the traced part: a pool cycle, and this long
NAME_CHARS = 160         # a device op's name in the breakdown, cut to this
COUNTER_ATTRS = ("launches", "reverse_launches", "reset_launches",
                 "vector_launches")


@dataclasses.dataclass
class Call:
    k: int                # call index in the window
    track: int            # pool index
    n: int                # frames
    seconds: float        # audio seconds
    ms: float             # wall ms of the call
    ok: bool


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    setup_s: float
    window_s: float
    calls: list
    spans: list
    trace: object
    counters: dict
    peaks: dict | None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def launch_counters() -> dict:
    """Every launch counter of the program's kernel wrappers."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("ame_tpu_torch.ops.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            for c in COUNTER_ATTRS:
                v = getattr(fn, c, None)
                if callable(fn) and isinstance(v, int):
                    out[f"{name.rsplit('.', 1)[1]}.{attr}.{c}"] = v
    return out


class CheckSample:
    """Which calls' masters are compared, drawn from the seed over the
    whole window: the first call after each of ``check - 1`` moments drawn
    uniformly in the first ``SPAN`` of the window, and the first call of
    the longest pool track after ``LATE`` of it, or earlier where that
    leaves under 1.5 pool cycles at ``cycle_s`` a cycle. Moments rather
    than call indices, so that the sample spreads over every window,
    however fast its calls are; a moment that no call followed leaves a
    master missing."""

    def __init__(self, mix: dict, seed: int, seconds: float,
                 cycle_s: float):
        ss = np.random.SeedSequence(int(seed)).spawn(int(mix["pool"]) + 2)
        n = int(mix.get("check", CHECK_TRACKS)) - 1
        draws = np.random.default_rng(ss[-1]).uniform(0.0, SPAN, n)
        self.moments = sorted(float(u) * seconds for u in draws)
        self.longest = int(np.argmax(traffic.lengths(mix)))
        self.late = max(min(LATE * seconds, seconds - 1.5 * cycle_s), 0.0)
        self.late_due = True
        self.calls: set[int] = set()

    def keep(self, k: int, track: int, elapsed: float) -> bool:
        """Whether call ``k`` of pool track ``track``, starting ``elapsed``
        seconds into the window, is compared."""
        keep = False
        if self.moments and self.moments[0] <= elapsed:
            self.moments.pop(0)
            keep = True
        if self.late_due and track == self.longest and elapsed >= self.late:
            self.late_due = False
            keep = True
        if keep:
            self.calls.add(k)
        return keep

    def unreached(self) -> int:
        """Sampled moments that no call of the window followed."""
        return len(self.moments) + self.late_due


class _Window:
    """The closed loop over the pool, one call at a time."""

    def __init__(self, api, sink, paths, tracks, settings, device, spans):
        self.api, self.sink, self.paths = api, sink, paths
        self.tracks, self.settings, self.device = tracks, settings, device
        self.spans = spans

    def master(self, k: int, idx: int, slot: int | None):
        """(Call, the master's bytes kept in sink slot ``slot`` or None,
        info or None)."""
        self.sink.expect(slot)
        if self.spans is not None:
            self.spans.call = k
        span = (self.spans.span("call") if self.spans is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        info, ok = None, True
        try:
            with span:
                info = self.api.master_file(
                    self.paths[idx], self.sink.path, self.settings,
                    device=self.device)
        except Exception:
            ok = False
            traceback.print_exc()
        ms = (time.perf_counter() - t0) * 1e3
        out = self.sink.collect() if ok else self._abandon()
        tr = self.tracks[idx]
        call = Call(k, idx, tr.pcm.shape[0], tr.seconds, ms, ok)
        return call, (out if slot is not None and ok else None), info

    def _abandon(self):
        for _ in range(600):
            self.sink.release()
            try:
                return self.sink.collect(timeout=0.1)
            except queue.Empty:
                continue
        raise RuntimeError("the FIFO reader never finished a failed call")


def _device_info(device: str, count: int) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i) for i in range(count)))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def _profiler(device: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", spec: Spec | None = None,
        mix: dict | None = None, out=None, err=None) -> int:
    """One run; prints the result as the last line of ``out`` and returns
    0, or returns another code without a result. ``device="cpu"`` (tests
    only) skips the look for a card and runs the program's plain
    versions."""
    out = out or sys.stdout
    err = err or sys.stderr
    spec = spec or Spec()
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    mix = mix or spec.mix(cell["traffic"])
    reference = spec.reference(cell["config"])
    chips = int(cell["chips"])
    if device == "cuda":
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if found < chips:
            print(f"cudabench: {workload} needs {chips} CUDA device(s); "
                  f"found {found}", file=err)
            return 2

    from ame_tpu_torch import api

    settings = config["settings"]
    tmp = tempfile.mkdtemp(prefix="cudabench-")
    sink = None
    try:
        # -- set-up: the pool, then one warm master a pool track ----------
        tracks = traffic.make_pool(mix, seed, device)
        paths = []
        for i, tr in enumerate(tracks):
            paths.append(os.path.join(tmp, f"in{i:02d}.wav"))
            with open(paths[-1], "wb") as f:
                f.write(wav.encode(tr.pcm, tr.sample_rate))
                f.flush()
                os.fsync(f.fileno())     # written back in set-up, not later
        sink = FifoSink(tmp, slot_bytes=max(map(os.path.getsize, paths))
                        + 65536,
                        slots=int(mix.get("check", CHECK_TRACKS)))
        spans = Spans() if trace else None
        loop = _Window(api, sink, paths, tracks, settings, device, None)
        warm = []
        for i in range(len(tracks)):
            call, data, info = loop.master(-1, i, slot=0)
            if not call.ok:
                print(f"cudabench: warm-up master of track {i} failed",
                      file=err)
                return 1
            pcm, _ = wav.decode(data)
            warm.append({"track": i, "seconds": round(call.seconds, 3),
                         **{k: info[k] for k in ("gain_db", "linear_mode")
                            if k in info},
                         "out_peak": int(np.abs(pcm.astype(np.int32)).max()),
                         "ms": round(call.ms, 3)})
        if trace:
            with _profiler(device):        # the profiler's own start-up
                torch.ones(8, device=device).sum().item()
        _sync(device)
        print(json.dumps({"warm": warm}), file=out)

        # -- the window ---------------------------------------------------
        order = traffic.order(mix, seed)
        sample = CheckSample(mix, seed, seconds, len(tracks) * float(
            np.median([w["ms"] for w in warm])) / 1e3)
        loop.spans = spans
        counters0 = launch_counters()
        calls, kept = [], {}
        prof, prof_calls, prof_t0 = None, [], None
        t_win0 = time.perf_counter()
        setup_s = t_win0 - t_start
        deadline = t_win0 + seconds
        k = 0
        with (spans.installed() if trace else contextlib.nullcontext()):
            while time.perf_counter() < deadline:
                idx = order[k % len(order)]
                if trace and prof is None and k == len(order):
                    prof = _profiler(device)
                    prof.__enter__()
                    prof_t0 = time.perf_counter()
                keep = sample.keep(k, idx, time.perf_counter() - t_win0)
                call, data, _ = loop.master(
                    k, idx, slot=len(kept) if keep else None)
                calls.append(call)
                if data is not None:
                    kept[k] = data
                if prof is not None and prof_t0 is not None:
                    prof_calls.append(k)
                    if (len(prof_calls) >= len(order) and
                            time.perf_counter() - prof_t0 >= PROFILE_MIN_S):
                        _sync(device)
                        prof.__exit__(None, None, None)
                        prof_t0 = None
                k += 1
        t_win1 = time.perf_counter()
        if prof is not None and prof_t0 is not None:
            _sync(device)
            prof.__exit__(None, None, None)
        counters1 = launch_counters()
        device_info = _device_info(device, chips)
        found = forbidden_modules()
        if found:
            print(f"cudabench: forbidden modules loaded: {found}", file=err)
            return 3

        reduced = None
        if prof is not None:
            from cudabench import trace as trace_mod
            reduced = trace_mod.reduce(prof.events(), prof_calls)
            device_info["busy_s"] = reduced.busy_s
            device_info["window_s"] = reduced.window_s
        prof = None
        if device == "cuda":
            torch.cuda.empty_cache()

        # -- the check ------------------------------------------------------
        t_check = time.perf_counter()
        checks, ref_info = _check(reference, settings, paths, calls, kept,
                                  sample)
        check_s = time.perf_counter() - t_check
        kept.clear()
        n_ok = sum(c.ok for c in calls)
        counters = {c: counters1[c] - counters0.get(c, 0) for c in counters1}
        run_ = Run(config=config, setup_s=setup_s,
                   window_s=t_win1 - t_win0, calls=calls,
                   spans=spans.records if spans else [], trace=reduced,
                   counters=counters,
                   peaks=(peak_table.for_device(device_info["kind"])
                          if device == "cuda" else None))
        wanted = spec.per_layer(workload) if trace else spec.end_to_end(
            workload)
        metrics = {}
        for m in wanted:
            value = spec.reader(m["name"]).read(run_)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

        print(json.dumps({"window": {"calls": len(calls), "ok": n_ok,
                                     "seconds": t_win1 - t_win0,
                                     "checked": sorted(sample.calls),
                                     "pipe_bytes": sink.pipe_bytes}}),
              file=out)
        print(json.dumps({"counters_per_call": {
            c: v / max(len(calls), 1) for c, v in sorted(counters.items())
            if v}}), file=out)
        print(json.dumps({"reference": ref_info, "check_s": check_s}),
              file=out)
        if spans is not None:
            print(json.dumps({"span_ms_total": _span_totals(spans.records)}),
                  file=out)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": correct, "attempted": len(calls),
                  "failed": len(calls) - n_ok, "metrics": metrics,
                  "device": device_info}
        if reduced is not None:
            result["breakdown"] = {
                "device_ops": sorted(([n[:NAME_CHARS], s] for n, s in
                                      reduced.device_ops.items()),
                                     key=lambda e: -e[1])[:10],
                "idle_gaps": [list(g) for g in reduced.gaps[:10]]}
        result["checks"] = checks
        found = forbidden_modules()       # the check and the readers too
        if found:
            print(f"cudabench: forbidden modules loaded: {found}", file=err)
            return 3
        for name, c in checks.items():
            print(f"check {name}: {c['value']} (limit {c['limit']})",
                  file=err)
        err.flush()
        print(json.dumps(result), file=out)
        out.flush()
        return 0
    finally:
        if sink is not None:
            sink.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _span_totals(records) -> dict:
    tot = {}
    for name, _, t0, t1 in records:
        tot[name] = tot.get(name, 0.0) + (t1 - t0) * 1e3
    return tot


def _check(reference, settings, paths, calls, kept, sample):
    """Every sampled master, against the reference run on the same input
    file; a sampled moment that no call followed leaves a master missing.
    Returns (checks, per-track reference info)."""
    failed = sum(not c.ok for c in calls)
    due = [c for c in calls if c.k in sample.calls]
    missing = (sum(c.k not in kept for c in due if c.ok)
               + sample.unreached())
    format_errors, max_lsb, infos = 0, 0, []
    for c in due:
        if c.k not in kept:
            continue
        with open(paths[c.track], "rb") as f:
            pcm_in, sr = wav.decode(f.read())
        info = {}
        want = reference.master(pcm_in, float(sr), settings, info=info)
        try:
            got, got_sr = wav.decode(kept[c.k])
        except ValueError:
            format_errors += 1
            continue
        if got_sr != sr or got.shape != want.shape:
            format_errors += 1
            continue
        diff = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
        max_lsb = max(max_lsb, diff)
        infos.append({"call": c.k, "track": c.track, "max_lsb": diff,
                      **{k: round(v, 6) for k, v in info.items()}})
    compared = len(infos)
    checks = {
        "failed_calls": {"value": failed, "limit": 0},
        "missing_masters": {"value": missing + (compared == 0), "limit": 0},
        "format_errors": {"value": format_errors, "limit": 0},
        "max_lsb": {"value": max_lsb, "limit": reference.LIMITS["max_lsb"]},
    }
    return checks, infos
