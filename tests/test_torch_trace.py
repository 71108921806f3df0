"""The port's spans (ame_tpu_torch.utils.telemetry.stage_timer) on the
``master_file`` path, on the CPU: off by default and then silent, one
``api.master`` root a call with its children nested inside it and sharing
its track, threads kept apart, the page-fault counter, the
``torch.profiler`` ranges, and ``master_graph(timer=)`` on the same clock."""

import contextlib
import mmap
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
        # 64 MB of fresh pages, written: an anonymous mapping of its own,
        # since malloc may hand back heap pages that earlier tests in the
        # process faulted in already
        fresh = mmap.mmap(-1, 64 << 20)
        with telemetry.tracing():
            with telemetry.stage_timer("touch") as span:
                a = np.frombuffer(fresh, np.uint8)
                a[:] = 1
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


# ---------------------------------------------------------------------------
# The loudness stage's spans (ops/loudness)
# ---------------------------------------------------------------------------

LOUD = {"bass_boost": 1.5, "lufs": -14.0}
LOUDNESS = ["loudness.kweight", "loudness.gate", "loudness.true_peak",
            "loudness.gain"]


def test_loudness_children_nest_under_the_stage(track, tmp_path):
    """At ``lufs=-14`` the stage ``chain.loudnorm`` holds four children in
    order, each inside it and on its track, with no device times on the
    CPU."""
    with telemetry.tracing():
        api.master_file(track, str(tmp_path / "out.wav"), LOUD,
                        device="cpu")
    spans = telemetry.records()
    (stage,) = [s for s in spans if s.name == "chain.loudnorm"]
    kids = sorted(_children(spans, stage), key=lambda s: s.t0)
    assert [s.name for s in kids] == LOUDNESS
    for s in kids:
        assert stage.t0 <= s.t0 <= s.t1 <= stage.t1
        assert s.track == stage.track and s.dev_t0 is None


@pytest.mark.parametrize("seconds", [2.5, 7.0])
def test_loudness_children_once_a_call_with_or_without_lra_blocks(seconds):
    """Under 3 s the gate measures no 3 s block, over it it does; either
    way a call records each child once, inside ``chain.loudnorm`` and in
    order, and none outside the stage."""
    x = torch.from_numpy(_signal(seconds))
    with telemetry.tracing():
        y, info = master_graph(x, SR, LOUD)
    spans = telemetry.records()
    (stage,) = [s for s in spans if s.name == "chain.loudnorm"]
    kids = [s for s in spans if s.name.startswith("loudness.")]
    assert [s.name for s in sorted(kids, key=lambda s: s.t0)] == LOUDNESS
    assert all(s.parent == stage.id for s in kids)
    assert kids == sorted(kids, key=lambda s: s.t1)
    assert (float(info["input_lra"]) > 0.0) == (seconds > 3.0)


def test_loudness_spans_off_record_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    master_graph(torch.from_numpy(_signal()), SR, LOUD)
    assert telemetry.records() == []
    with telemetry.stage_timer("x", torch.device("cuda")) as span:
        assert span is None


def test_fused_replay_keeps_its_bits_under_tracing():
    """``master_graph_fused`` (eager on the CPU, the formulation a card
    captures) equals ``master_graph`` bit for bit, traced or not."""
    from ame_tpu_torch.graph.chain import master_graph_fused
    x = torch.from_numpy(_signal(2.0))
    y0, i0 = master_graph(x, SR, LOUD)
    for traced in (False, True):
        with telemetry.tracing() if traced else contextlib.nullcontext():
            y1, i1 = master_graph_fused(x, SR, LOUD)
        assert torch.equal(y0, y1)
        assert set(i0) == set(i1)
        assert all(torch.equal(i0[k], i1[k]) for k in i0)


class _Event:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def record(self, stream=None):
        self.log.append(self.name)


@pytest.mark.parametrize("capturing", [False, True])
def test_a_card_span_brackets_its_work_with_an_event_pair(monkeypatch,
                                                          capturing):
    """On a CUDA device a recorded span records a start event before its
    body and an end event after it, and hands them to the recorder; under
    a stream capture it records none. No card here: the events and the
    capture query are stand-ins."""
    log = []

    def event_pair(span, device):
        span.events = ("ref", "start", "end")
        return _Event(log, "start"), _Event(log, "end")

    monkeypatch.setattr(telemetry, "event_pair", event_pair)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    with telemetry.tracing() as recorder:
        with telemetry.stage_timer("card", torch.device("cuda")) as span:
            log.append("body")
    assert log == (["body"] if capturing else ["start", "body", "end"])
    assert (span.events is None) == capturing
    assert (span in recorder._pending) != capturing
