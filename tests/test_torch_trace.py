"""The port's spans (ame_tpu_torch.utils.telemetry.stage_timer) on the
``master_file`` path, on the CPU: off by default and then silent, one
``api.master`` root a call with its children nested inside it and sharing
its track, threads kept apart, the page-fault counter, the
``torch.profiler`` ranges, and ``master_graph(timer=)`` on the same clock."""

import contextlib
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from ame_tpu_torch import api
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.io.wav import write_wav
from ame_tpu_torch.utils import telemetry

SR = 44100
SETTINGS = {"bass_boost": 1.5, "lufs": None}
STAGES = {"chain.analog_eq_width", "chain.limiter"}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """No recorder from an earlier test: records() starts empty."""
    monkeypatch.setattr(telemetry, "_recorder", None)


def _signal(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((int(seconds * SR), 2)) * 0.1).astype(
        np.float32)


@pytest.fixture
def track(tmp_path):
    path = tmp_path / "in.wav"
    write_wav(str(path), _signal(), SR)
    return str(path)


def _master(entry, track, out):
    if entry == "master_file":
        return api.master_file(track, out, SETTINGS, device="cpu")
    audio = _signal()
    return api.master_array(audio, SR, out, SETTINGS, device="cpu")


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_tracing_off_records_nothing(track, tmp_path, monkeypatch):
    """Off, a span site enters no profiler range even while a profiler
    session is active, and nothing is recorded."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    assert not telemetry._on
    api.master_file(track, str(tmp_path / "out.wav"), SETTINGS,
                    device="cpu")
    assert telemetry.records() == []
    with telemetry.stage_timer("x") as span:
        assert span is None


@pytest.mark.parametrize("entry", ["master_file", "master_array"])
def test_one_call_is_one_root_with_its_children_inside(entry, track,
                                                       tmp_path):
    with telemetry.tracing() as recorder:
        _master(entry, track, str(tmp_path / "out.wav"))
    spans = telemetry.records()
    assert spans == recorder.records()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "api.master"
    want = ["io.decode"] if entry == "master_file" else []
    want += ["api.upload", "chain", "api.fetch", "io.write"]
    assert [s.name for s in sorted(_children(spans, root),
                                   key=lambda s: s.t0)] == want
    (chain,) = [s for s in spans if s.name == "chain"]
    assert {s.name for s in _children(spans, chain)} == STAGES
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.track == root.id and s.thread == root.thread
        assert s.t0 <= s.t1 and s.faults >= 0
        assert s.dev_t0 is None and s.dev_t1 is None   # no card
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    # the recorder stays readable after the extent, and records nothing more
    api.master_array(_signal(), SR, str(tmp_path / "out2.wav"), SETTINGS,
                     device="cpu")
    assert len(telemetry.records()) == len(spans)


def test_concurrent_calls_get_their_own_tracks(tmp_path):
    barrier = threading.Barrier(2)
    errors = []

    def work(i):
        try:
            barrier.wait(timeout=30)
            for k in range(2):
                api.master_array(_signal(seed=i), SR,
                                 str(tmp_path / f"out{i}{k}.wav"), SETTINGS,
                                 device="cpu")
        except Exception as e:       # reported by the main thread
            errors.append(e)

    with telemetry.tracing():
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
    spans = telemetry.records()
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 4 and len({r.track for r in roots}) == 4
    assert len({r.thread for r in roots}) == 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            assert by_id[s.parent].thread == s.thread
            assert by_id[s.parent].track == s.track
        assert by_id[s.track].thread == s.thread
    for r in roots:
        assert sum(s.track == r.id for s in spans) == 7   # root, 4 + 2


class _Usage:
    def __init__(self, minflt):
        self.ru_minflt = minflt


@pytest.mark.parametrize("mode", ["reading", "touch"])
def test_faults_are_the_threads_getrusage_delta(mode, monkeypatch):
    if mode == "reading":
        readings = iter([1000, 1007, 1500, 1730])
        monkeypatch.setattr(telemetry.resource, "getrusage",
                            lambda who: _Usage(next(readings)))
        with telemetry.tracing():
            with telemetry.stage_timer("outer"):
                with telemetry.stage_timer("inner"):
                    pass
        inner, outer = telemetry.records()
        assert (inner.faults, outer.faults) == (1500 - 1007, 1730 - 1000)
    else:
        with telemetry.tracing():
            with telemetry.stage_timer("touch") as span:
                a = np.ones(64 << 20, np.uint8)     # 64 MB, written
        assert span.faults > 0 and a[-1] == 1


def test_spans_are_profiler_ranges_with_the_same_nesting(track, tmp_path):
    """Each span is a range ``ame.<name>`` inside it, nested as the spans
    are; their durations differ by the range's own cost, under 1 ms (the
    median of three sessions: a host that preempts the process inside a
    range's bookkeeping makes one session's reading long)."""
    diffs: dict = {}
    for _ in range(3):
        with telemetry.tracing() as recorder:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                # a session's first range pays the profiler's set-up (ms)
                with torch.profiler.record_function("first"):
                    pass
                api.master_file(track, str(tmp_path / "out.wav"), SETTINGS,
                                device="cpu")
            # a range only inside a session
            with telemetry.stage_timer("after"):
                pass
        spans = [s for s in recorder.records() if s.name != "after"]
        ranges = {e.name[4:]: e for e in prof.events()
                  if e.name.startswith("ame.")}
        assert set(ranges) == {s.name for s in spans}
        by_id = {s.id: s for s in spans}
        for s in spans:
            r = ranges[s.name]
            range_ms = (r.time_range.end - r.time_range.start) / 1e3
            span_ms = (s.t1 - s.t0) * 1e3
            assert range_ms <= span_ms + 0.01      # the range is inside
            diffs.setdefault(s.name, []).append(span_ms - range_ms)
            if s.parent is not None:
                p = ranges[by_id[s.parent].name]
                assert p.time_range.start <= r.time_range.start
                assert r.time_range.end <= p.time_range.end
    assert all(sorted(d)[1] < 1.0 for d in diffs.values()), diffs


@pytest.mark.parametrize("traced", [False, True])
def test_master_graph_timer_is_filled(traced):
    x = torch.from_numpy(_signal())
    timer = {}
    with telemetry.tracing() if traced else contextlib.nullcontext():
        master_graph(x, SR, SETTINGS, timer=timer)
    assert set(timer) == {s.split(".", 1)[1] for s in STAGES}
    assert all(v > 0 for v in timer.values())
    stages = {s.name: s for s in telemetry.records()
              if s.name.startswith("chain.")}
    if traced:
        assert set(stages) == STAGES
        for name, s in stages.items():   # the stage's span times the stage
            assert timer[name[6:]] <= s.t1 - s.t0
    else:
        assert stages == {}


def test_extents_nest_and_the_deque_is_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "TRACE_RECORDS", 3)
    with telemetry.tracing() as outer:
        with telemetry.tracing() as inner:
            assert inner is outer
        assert telemetry._on
        for i in range(5):
            with telemetry.stage_timer(f"s{i}"):
                pass
    assert not telemetry._on
    assert [s.name for s in telemetry.records()] == ["s2", "s3", "s4"]
