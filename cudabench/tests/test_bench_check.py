"""The check that decides ``correct``: the program's masters pass it, the
control (the reference in TF32, the precision below the configuration's
float32 with TF32 off) fails it, and a run whose timed path is broken
underneath comes out not correct, once for each fault the cells can have.
On the CPU, at sizes a test run holds; the chip runs the same at the
cells' sizes (PERF.md)."""

import io
import json
import time

import numpy as np
import pytest

from ame_tpu_torch import api
from ame_tpu_torch.graph import chain
from cudabench import harness, traffic
from cudabench.reference import wav
from cudabench.spec import Spec

SEED = 2**32 + 99
CELL = "quality_flagship_nolufs.album_dynamic"


def _small_mix(spec, seconds=4.0, pool=3):
    mix = spec.mix(spec.cell(CELL)["traffic"])
    mix["lengths"] = {"kind": "fixed", "seconds": seconds}
    mix["pool"] = pool
    return mix


def test_program_passes_and_control_fails(tmp_path):
    spec = Spec()
    cell = spec.cell(CELL)
    config = spec.config(cell["config"])
    ref = spec.reference(cell["config"])
    limit = ref.LIMITS["max_lsb"]
    for tr in traffic.make_pool(_small_mix(spec, 12.0, 2), SEED, "cpu"):
        path = tmp_path / "in.wav"
        path.write_bytes(wav.encode(tr.pcm, tr.sample_rate))
        api.master_file(str(path), str(tmp_path / "out.wav"),
                        config["settings"], device="cpu")
        got, _ = wav.decode((tmp_path / "out.wav").read_bytes())
        want = ref.master(tr.pcm, 44100.0, config["settings"])
        control = ref.master(tr.pcm, 44100.0, config["settings"],
                             mantissa_bits=10)
        assert np.abs(got.astype(int) - want).max() <= limit
        assert np.abs(control.astype(int) - want).max() > limit


def _run(spec, mix, seconds=1.5):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(CELL, SEED, seconds, False, t_start=time.perf_counter(),
                     device="cpu", spec=spec, mix=mix, out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct():
    spec = Spec()
    res = _run(spec, _small_mix(spec))
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"audio_x_realtime", "setup_s"}


def _unchanged(y, x):
    return x


def _half_left_out(y, x):
    y = y.clone()
    y[:y.shape[0] // 2] = 0.0     # every track starts with an on section
    return y


def _one_sample_altered(y, x):
    y = y.clone()
    y[y.shape[0] // 3, 0] += 0.01
    return y


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _one_sample_altered])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    spec = Spec()
    mix = _small_mix(spec)
    real = chain.master_graph
    broken = {"on": False}

    def master_graph(x, sample_rate, settings, *args, **kwargs):
        y, info = real(x, sample_rate, settings, *args, **kwargs)
        return (fault(y, x) if broken["on"] else y), info

    monkeypatch.setattr(chain, "master_graph", master_graph)
    real_order = traffic.order

    def order(m, seed):          # the window's calls are the broken ones
        broken["on"] = True
        return real_order(m, seed)

    monkeypatch.setattr(traffic, "order", order)
    res = _run(spec, mix)
    assert res["correct"] is False
    assert res["checks"]["max_lsb"]["value"] > res["checks"]["max_lsb"][
        "limit"]


def test_a_failing_call_is_not_correct(monkeypatch):
    spec = Spec()
    mix = _small_mix(spec)
    real = chain.master_graph
    calls = {"n": 0}

    def master_graph(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == mix["pool"] + 2:      # the window's second call
            raise RuntimeError("planted failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(chain, "master_graph", master_graph)
    res = _run(spec, mix)
    assert res["correct"] is False and res["failed"] == 1


def _replay(sample, order, ms, seconds):
    """Feed ``sample`` a window of calls ``ms`` long each."""
    k, t = 0, 0.0
    while t < seconds:
        sample.keep(k, order[k % len(order)], t)
        k, t = k + 1, t + ms / 1e3
    return k


@pytest.mark.parametrize("ms", [2.0, 40.0, 300.0])
def test_sample_spreads_over_the_whole_window(ms):
    spec = Spec()
    mix = spec.mix(spec.cell(CELL)["traffic"])
    order = traffic.order(mix, SEED)
    longest = int(np.argmax(traffic.lengths(mix)))
    sample = harness.CheckSample(mix, SEED, 30.0, 12 * ms / 1e3)
    moments = list(sample.moments)
    n = _replay(sample, order, ms, 30.0)
    assert sample.unreached() == 0 and len(sample.calls) == mix["check"]
    assert max(sample.calls) < n
    late = min(harness.LATE * 30.0, 30.0 - 1.5 * 12 * ms / 1e3)
    assert any(order[k % len(order)] == longest
               and k * ms / 1e3 >= late for k in sample.calls)
    # the same moments for the seed, others for another seed
    assert moments == harness.CheckSample(mix, SEED, 30.0, 1.0).moments
    assert moments != harness.CheckSample(mix, SEED + 1, 30.0, 1.0).moments
    assert all(0 <= m < harness.SPAN * 30.0 for m in moments)


def test_a_short_window_still_reaches_the_longest_track():
    """A window of a few pool cycles: the longest track's call comes
    early enough that a full cycle still follows it."""
    spec = Spec()
    mix = spec.mix(spec.cell(CELL)["traffic"])
    order = traffic.order(mix, SEED)
    for ms in (100.0, 170.0, 250.0):
        sample = harness.CheckSample(mix, SEED, 3.0, 12 * ms / 1e3)
        _replay(sample, order, ms, 3.0)
        assert sample.unreached() == 0


def test_a_sampled_call_the_window_never_reached_is_missing(monkeypatch):
    monkeypatch.setattr(harness, "SPAN", 100.0)
    spec = Spec()
    res = _run(spec, _small_mix(spec))
    assert res["correct"] is False and res["failed"] == 0
    assert res["checks"]["missing_masters"]["value"] >= 1
