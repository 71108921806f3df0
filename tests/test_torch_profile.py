"""The port's profiler (ame_tpu_torch.utils.profiler.profile_master and
``python -m ame_tpu_torch profile``) on the CPU: ame_tpu's report keys,
ame_tpu's stage names in both modes, cold start and steady state from the
fused program and stages from the staged chain, and a Chrome trace
written by telemetry.profile_trace (tests/test_cli.py:106-128's
contract)."""

import json
import os

import numpy as np
import pytest
import torch

from ame_tpu_torch.cli import main
from ame_tpu_torch.io.wav import write_wav
from ame_tpu_torch.utils import telemetry
from ame_tpu_torch.utils.profiler import profile_master
from tests.conftest import make_test_signal

SR = 44100


@pytest.fixture
def track(tmp_path):
    p = str(tmp_path / "in.wav")
    write_wav(p, make_test_signal("noise", 4096, SR) * 0.2, SR)
    return p


def _report(capsys):
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def test_cli_profile(track, tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    rc = main(["profile", track, "--runs", "2", "--lufs", "-16",
               "--bass", "1.5", "--trace", trace_dir, "--device", "cpu"])
    assert rc == 0
    rep = _report(capsys)
    assert rep["n_samples"] == 4096 and rep["mode"] == "quality"
    assert rep["device"] == "cpu" and rep["trace_dir"] == trace_dir
    assert rep["x_realtime"] > 0 and rep["cold_start_s"] > 0
    assert rep["steady_ms"] > 0 and rep["steady_host_ms"] > 0
    assert set(rep["stages_ms"]) == {"analog_eq_width", "loudnorm",
                                     "limiter"}
    assert all(v >= 0 for v in rep["stages_ms"].values())
    assert rep["host_rss_mb"] is None or rep["host_rss_mb"] > 0
    traces = [e.path for e in os.scandir(trace_dir)]
    assert traces and all(p.endswith(".json") for p in traces)
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert events


def test_cli_profile_compat_stages(track, capsys):
    rc = main(["profile", track, "--runs", "1", "--mode", "compat",
               "--multiband", "--no-lufs", "--device", "cpu"])
    assert rc == 0
    rep = _report(capsys)
    assert rep["mode"] == "compat"
    assert set(rep["stages_ms"]) == {"eq_width", "multiband", "limiter"}


def test_profile_report_keys_match_reference(track):
    """Every key of ame_tpu's profile_master report on the same track is in
    the port's (hbm_peak_mb only where a device reports memory), and the
    stage names are equal."""
    from ame_tpu.utils.profiler import profile_master as ref_profile_master
    from ame_tpu_torch.io import read_audio
    x, _ = read_audio(track)
    settings = {"bass_boost": 1.5, "lufs": -16.0}
    ref = ref_profile_master(x, SR, settings, runs=2)
    rep = profile_master(x, SR, settings, runs=2, device="cpu")
    assert set(ref) - {"hbm_peak_mb"} <= set(rep)
    assert set(rep) - set(ref) <= {"device", "steady_host_ms",
                                   "hbm_peak_mb"}
    assert set(rep["stages_ms"]) == set(ref["stages_ms"])
    assert rep["n_samples"] == ref["n_samples"]
    assert rep["seconds"] == ref["seconds"]


def test_profile_times_the_fused_program(track, monkeypatch):
    """As ame_tpu's profiler: cold start and each steady run are one
    master_graph_fused call, the stages come from the staged chain (a warm
    call and runs // 2 timed ones), and the note says which is which."""
    from ame_tpu_torch.graph import chain
    from ame_tpu_torch.io import read_audio
    calls = {"fused": 0, "staged": 0}
    fused, staged = chain.master_graph_fused, chain.master_graph

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(chain, "master_graph_fused", count("fused", fused))
    monkeypatch.setattr(chain, "master_graph", count("staged", staged))
    x, _ = read_audio(track)
    rep = profile_master(x, SR, {"bass_boost": 1.5}, runs=4, device="cpu")
    assert calls == {"fused": 1 + 4, "staged": 1 + 2}
    assert "fused program" in rep["stages_note"]
    assert rep["cold_start_s"] > 0 and rep["steady_ms"] > 0


def test_profile_master_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_master(np.zeros((1024, 2), np.float32), SR, {})


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "t")
    with telemetry.profile_trace(d) as logdir:
        torch.ones(8).cumsum(0)
    assert logdir == d
    (trace,) = os.listdir(d)
    assert trace == f"trace_{os.getpid()}.json"
    with open(os.path.join(d, trace)) as f:
        assert "traceEvents" in json.load(f)
