"""The program's spans in a run of a cell (``cudabench/program_trace.py``),
on the CPU at the small sizes of ``test_bench_check.py``: a traced run
reports the metrics read from the program's spans and prints the device's
idle time by span; an untraced run reports none of them and leaves the
program's tracing off; ``idle_by_span`` on synthetic profiler events sums
to the window less its busy time; a program with no recorder gives the
readers nothing to read."""

import io
import json
import time
import types

import pytest
import torch

from ame_tpu_torch.utils import telemetry
from cudabench import program_trace, trace
from cudabench.spec import Spec
from cudabench.tests.test_bench_check import CELL, SEED, _small_mix

NEW = {m["name"] for m in program_trace.METRICS}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    monkeypatch.setattr(telemetry, "_recorder", None)


def _run(traced):
    spec = Spec()
    out, err = io.StringIO(), io.StringIO()
    rc = program_trace.run(CELL, SEED, 1.5, traced,
                           t_start=time.perf_counter(), device="cpu",
                           spec=spec, mix=_small_mix(spec), out=out, err=err)
    assert rc == 0, err.getvalue()
    lines = [json.loads(ln) for ln in out.getvalue().strip().splitlines()]
    return lines[:-1], lines[-1]


def test_traced_run_reports_the_program_metrics():
    lines, res = _run(True)
    assert res["correct"] is True
    got = set(res["metrics"]) & NEW
    assert got == NEW - {"chain.device_ms"}      # no device times on a CPU
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["api.upload_ms"] > 0 and m["api.fetch_ms"] > 0
    assert m["api.self_ms"] >= 0 and m["api.setup_ms"] > 0
    assert m["api.call_faults"] >= m["io.decode_faults"] >= 0
    assert m["api.call_faults"] >= m["io.write_faults"] >= 0
    (idle,) = [ln["idle_by_span"] for ln in lines if "idle_by_span" in ln]
    assert idle and all(v >= 0 for v in idle.values())
    # no device on a CPU: the whole window is idle
    assert sum(idle.values()) == pytest.approx(
        res["device"]["window_s"] - res["device"]["busy_s"], rel=1e-9)
    assert set(idle) <= {"none", "api.master", "io.decode", "api.upload",
                         "chain", "chain.analog_eq_width", "chain.limiter",
                         "api.fetch", "io.write"}
    (split,) = [ln["call_split"] for ln in lines if "call_split" in ln]
    assert split["calls"] >= 1
    assert split["ms"]["api.upload"] == pytest.approx(m["api.upload_ms"])
    # the program's spans sit inside the harness's wrappers
    for mine, theirs in (("io.decode", "io.decode_ms"),
                         ("io.write", "io.write_ms"),
                         ("chain", "chain.call_ms")):
        assert split["ms"][mine] <= m[theirs]
    assert not telemetry._on


def test_untraced_run_reports_none_and_leaves_tracing_off(monkeypatch):
    seen = []
    real = telemetry.stage_timer

    def stage_timer(name):
        seen.append(telemetry._on)
        return real(name)

    for mod in ("ame_tpu_torch.api", "ame_tpu_torch.io.audio_file"):
        monkeypatch.setattr(f"{mod}.stage_timer", stage_timer)
    lines, res = _run(False)
    assert res["correct"] is True and not set(res["metrics"]) & NEW
    assert not any("idle_by_span" in ln for ln in lines)
    assert seen and not any(seen)
    assert telemetry.records() == []


def _evt(name, a, b, device=False, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        is_user_annotation=annotation)


def test_idle_by_span_splits_the_idle_time_exactly():
    # microseconds: two calls, nested program ranges, kernels and copies
    events = [
        _evt("bench.call", 100, 600), _evt("bench.call", 650, 1000),
        _evt("ame.api.master", 105, 595), _evt("ame.io.decode", 110, 300),
        _evt("ame.chain", 310, 420), _evt("ame.chain.limiter", 330, 410),
        _evt("ame.api.fetch", 430, 500), _evt("ame.api.master", 660, 990),
        _evt("ame.io.decode", 670, 800),
        _evt("kernel_a", 320, 360, device=True),
        _evt("kernel_b", 350, 380, device=True),     # overlaps kernel_a
        _evt("Memcpy_DtoH", 450, 490, device=True),
        _evt("kernel_c", 50, 120, device=True),      # starts before w0
        _evt("kernel_d", 990, 1200, device=True),    # ends after w1
        _evt("ame.chain", 330, 400, device=True, annotation=True),
    ]
    split = program_trace.idle_by_span(events)
    t = trace.reduce(events, [0, 1])
    assert sum(split.values()) == pytest.approx(t.window_s - t.busy_s,
                                                abs=1e-15)
    # idle: [120, 320], [380, 450], [490, 990]
    want = {"none": 660 - 595,
            "api.master": (310 - 300) + (430 - 420) + (595 - 500)
            + (670 - 660) + (990 - 800),
            "io.decode": (300 - 120) + (800 - 670),
            "chain": (320 - 310) + (420 - 410),
            "chain.limiter": 410 - 380,
            "api.fetch": (450 - 430) + (500 - 490)}
    assert split == pytest.approx({k: v * 1e-6 for k, v in want.items()},
                                  abs=1e-15)
    assert program_trace.program_ranges(events) == {"host": 7,
                                                    "device_copies": 1}


def test_a_program_without_a_recorder_gives_nothing(monkeypatch):
    """The readers read nothing, and raise nothing, where the program has
    no ``records`` (a parent commit) or recorded no spans."""
    run = types.SimpleNamespace(spans=[("call", 0, 0.0, 1.0)], calls=[],
                                window_s=1.0)
    spec = Spec()
    assert all(spec.reader(n).read(run) is None for n in NEW)
    monkeypatch.delattr(telemetry, "records")
    assert program_trace.spans() == []
    assert all(spec.reader(n).read(run) is None for n in NEW)
