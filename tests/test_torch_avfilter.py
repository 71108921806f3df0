"""The port's golden-FFmpeg harness (ame_tpu_torch.io.avfilter over its own
copy of io/native/amefilter.cpp, built by ops._build.build_host) and the
port's loudnorm / alimiter held against the REAL FFmpeg filters through it
— the live half of tests/test_golden_ffmpeg.py, with its bounds. Live tests
skip where the harness is unavailable; the log parser and the harness's
degrade path always run. Nothing here calls ame_tpu.io.avfilter: it builds
its shim in place."""

import json
import math
import os
import zlib

import numpy as np
import pytest
import torch

from ame_tpu_torch.io import avfilter as F

SR = 44100
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_ffmpeg.json")


@pytest.fixture
def ffmpeg():
    """Skips the test where the real filter stack is unavailable (decided
    when the test runs, not when the module is imported)."""
    if not F.available():
        pytest.skip(f"FFmpeg filter stack unavailable: "
                    f"{F.unavailable_reason()}")


def make_signal(kind: str) -> np.ndarray:
    """tests/test_golden_ffmpeg.py's measurement signals (12 s stereo)."""
    r = np.random.default_rng(zlib.crc32(kind.encode()))
    t = np.arange(SR * 12) / SR
    if kind == "alt":          # 3 s quiet / 3 s loud alternation, wide LRA
        env = np.where((t % 6) < 3, 0.08, 0.5)
    elif kind == "hot":        # clipping-hot steady bed
        env = 0.95 * np.ones_like(t)
    elif kind == "quiet":
        env = 0.02 * np.ones_like(t)
    elif kind == "ramp":       # smooth crescendo, moderate LRA
        env = 0.05 + 0.5 * t / t[-1]
    elif kind == "multi":      # quiet verse + loud chorus islands
        env = np.full_like(t, 0.25)
        env[(t >= 3) & (t < 6)] = 0.04
        env[(t >= 8) & (t < 10)] = 0.7
    else:
        raise ValueError(kind)
    x = env * np.sin(2 * np.pi * 220 * t) \
        + 0.12 * env * r.standard_normal(t.size)
    return np.clip(np.stack([x, 0.85 * x], 1), -1, 1).astype(np.float32)


def limiter_signal(kind: str) -> np.ndarray:
    """tests/test_golden_ffmpeg.py's limiter signals (6 s stereo)."""
    r = np.random.default_rng(7)
    t = np.arange(SR * 6) / SR
    if kind == "hot_music":
        env = 0.5 + 0.45 * np.sin(2 * np.pi * 0.7 * t)
        a = 1.3 * env * np.sin(2 * np.pi * 220 * t) \
            + 0.3 * env * r.standard_normal(t.size)
        return np.stack([a, 0.9 * a], 1).astype(np.float32)
    if kind == "impulses":
        b = 0.4 * np.sin(2 * np.pi * 330 * t)
        b[::SR // 3] = 1.8
        return np.stack([b, b], 1).astype(np.float32)
    if kind == "bursts":
        c = 0.6 * np.sin(2 * np.pi * 110 * t)
        c = np.where((t % 2) < 0.05, c * 2.2, c)
        return np.stack([c, 0.8 * c], 1).astype(np.float32)
    raise ValueError(kind)


MEASURE_KINDS = ("alt", "hot", "quiet", "ramp", "multi")
LIMITER_KINDS = ("hot_music", "impulses", "bursts")
LIMITER_RMS_BOUND_DB = {"hot_music": -26.0, "impulses": -50.0,
                        "bursts": -40.0}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _floats(stats: dict) -> dict:
    return {k: (float(v) if isinstance(v, torch.Tensor) else v)
            for k, v in stats.items()}


def _linear_mode_stats(x):
    _, _, st = F.loudnorm_pass2(
        x, SR, {"input_i": -10.0, "input_tp": -3.0, "input_lra": 5.0,
                "input_thresh": -20.0, "target_offset": 0.0},
        i=-24.0, tp=0.0, lra=20.0)
    assert st["normalization_type"] == "linear"
    return st


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

def _ffmpeg_log(stats: dict) -> str:
    """A loudnorm print_format=json block as ffmpeg logs it: every value a
    string, inside the filter's log lines."""
    body = ",\n".join(f'\t"{k}" : "{v}"' for k, v in stats.items())
    return ("[Parsed_loudnorm_0 @ 0x5581] \n{\n" + body + "\n}\n"
            "[out] EOF on sink link out:default.\n")


def test_parse_loudnorm_json_on_the_fixture_stats():
    """Every pass-1 record of the committed fixture, written out as
    ffmpeg's log block, parses back to the recorded numbers; -inf and
    non-numeric fields keep their meaning."""
    with open(FIXTURE) as f:
        fixture = json.load(f)
    records = [d["p1"] for d in fixture["dynamic"].values()]
    assert records
    for p1 in records:
        log = _ffmpeg_log({**p1, "normalization_type": "dynamic"})
        got = F.parse_loudnorm_json(log)
        assert got == {**{k: float(v) for k, v in p1.items()},
                       "normalization_type": "dynamic"}
    got = F.parse_loudnorm_json(_ffmpeg_log({"input_i": "-inf",
                                             "input_tp": "-inf"}))
    assert got["input_i"] == -math.inf
    with pytest.raises(ValueError, match="no loudnorm JSON"):
        F.parse_loudnorm_json("[aformat] nothing here\n")


def test_unavailable_reason_when_no_library(monkeypatch):
    """AME_TPU_AVFILTER pointing nowhere: the harness reports unavailable,
    with the reason, and run_filter raises."""
    monkeypatch.setattr(F, "_lib", None)
    monkeypatch.setattr(F, "_lib_tried", False)
    monkeypatch.setattr(F, "_reason", None)
    monkeypatch.setenv("AME_TPU_AVFILTER", "/nonexistent/libavfilter.so")
    assert F.available() is False
    assert "no libavfilter" in F.unavailable_reason()
    with pytest.raises(RuntimeError, match="unavailable"):
        F.run_filter(np.zeros((16, 2), np.float32), SR, "anull")


def test_harness_round_trips_anull(ffmpeg):
    x = np.random.default_rng(0).uniform(-1, 1, (SR // 2, 2)).astype(
        np.float32)
    y, sr, _ = F.run_filter(x, SR, "anull")
    assert sr == SR
    np.testing.assert_array_equal(y, x)
    assert F.unavailable_reason() is None


# ---------------------------------------------------------------------------
# Live: measurement parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", MEASURE_KINDS)
def test_measure_matches_real_loudnorm(kind, ffmpeg):
    """I / LRA / thresh within 0.05 LU of the real filter at native rate."""
    from ame_tpu_torch.ops.loudness import measure
    x = make_signal(kind)
    st = _linear_mode_stats(x)
    m = _floats(measure(_t(x), SR))
    assert abs(m["input_i"] - st["input_i"]) < 0.05
    assert abs(m["input_lra"] - st["input_lra"]) < 0.05
    assert abs(m["input_thresh"] - st["input_thresh"]) < 0.05


def test_pass1_dynamic_measurement_bounds(ffmpeg):
    """The port's loudnorm_pass1 against the real dynamic-mode pass 1:
    input fields within 0.35 (thresh 1.0), target_offset within 0.25."""
    from ame_tpu_torch.ops.loudnorm import loudnorm_pass1
    worst_offset = 0.0
    for kind in MEASURE_KINDS:
        x = make_signal(kind)
        ff = F.loudnorm_pass1(x, SR)
        m = _floats(loudnorm_pass1(_t(x), SR))
        assert abs(m["input_i"] - ff["input_i"]) < 0.35, kind
        assert abs(m["input_lra"] - ff["input_lra"]) < 0.35, kind
        assert abs(m["input_thresh"] - ff["input_thresh"]) < 1.0, kind
        assert abs(m["input_tp"] - ff["input_tp"]) < 0.35, kind
        worst_offset = max(worst_offset,
                           abs(m["target_offset"] - ff["target_offset"]))
    assert worst_offset < 0.25


def test_true_peak_matches_dynamic_mode_tp(ffmpeg):
    from ame_tpu_torch.ops.loudness import measure
    for kind in ("alt", "ramp", "multi"):
        x = make_signal(kind)
        p1 = F.loudnorm_pass1(x, SR)
        tp = float(measure(_t(x), SR)["input_tp"])
        assert abs(tp - p1["input_tp"]) < 0.3, (kind, tp, p1["input_tp"])


def test_pass2_linear_waveform_parity(ffmpeg):
    """Linear-eligible content: the port's two-pass flow applies the real
    filter's single gain within 0.1 dB, pointwise residual < 1e-3."""
    from ame_tpu_torch.ops.loudnorm import loudnorm_two_pass
    x = make_signal("ramp")
    p1 = F.loudnorm_pass1(x, SR)
    yf, osr, st = F.loudnorm_pass2(x, SR, p1, i=-14.0, tp=-1.5, lra=11.0)
    assert st["normalization_type"] == "linear" and osr == SR
    y, info = loudnorm_two_pass(_t(x), SR, -14.0, -1.5, 11.0)
    assert float(info["linear_mode"]) == 1.0
    ours = y.numpy()
    n = min(len(yf), len(ours))
    gain_err_db = 20 * np.log10(np.linalg.norm(ours[:n])
                                / np.linalg.norm(yf[:n]))
    assert abs(gain_err_db) < 0.1
    scale = float(np.dot(ours[:n, 0], yf[:n, 0])
                  / np.dot(yf[:n, 0], yf[:n, 0]))
    assert np.abs(ours[:n, 0] - scale * yf[:n, 0]).max() < 1e-3


def test_steady_track_forces_dynamic_quirk(ffmpeg):
    """measured_LRA == 0.0 reads as unset: a steady track never takes
    linear mode, in the real filter or in the port."""
    from ame_tpu_torch.ops.loudnorm import loudnorm
    x = make_signal("quiet")
    p1 = F.loudnorm_pass1(x, SR)
    assert p1["input_lra"] == 0.0
    _, _, st = F.loudnorm_pass2(x, SR, p1, i=-14.0, tp=-1.5, lra=11.0)
    assert st["normalization_type"] == "dynamic"
    _, info = loudnorm(_t(x), SR, -14.0, -1.5, 11.0, measured=p1,
                       offset=p1["target_offset"])
    assert float(info["linear_mode"]) == 0.0


# ---------------------------------------------------------------------------
# Live: alimiter
# ---------------------------------------------------------------------------

def _aligned_diff(ours: np.ndarray, ff: np.ndarray, max_lag: int = 600):
    """Best-lag aligned (rms_diff_db, lag): ffmpeg delays by its lookahead,
    the port's limiter is anticipatory (zero latency)."""
    n = min(len(ours), len(ff)) - max_lag
    a = ours[:n, 0]
    best = (0, np.inf)
    for lag in range(max_lag):
        d = a - ff[lag:lag + n, 0]
        e = float(np.dot(d, d))
        if e < best[1]:
            best = (lag, e)
    lag, e = best
    rms = np.sqrt(np.dot(a, a) / n)
    return 20 * np.log10(np.sqrt(e / n) / max(rms, 1e-12)), lag


@pytest.mark.parametrize("kind", LIMITER_KINDS)
def test_alimiter_golden(kind, ffmpeg):
    """The reference's exact alimiter invocation vs the port's
    alimiter_compat: both auto-level to a 1.0 ceiling, and the waveforms
    agree within the class's bound after delay alignment."""
    from ame_tpu_torch.ops.limiter import alimiter_compat
    x = limiter_signal(kind)
    yf, osr = F.alimiter(x, SR)
    assert osr == SR and len(yf) == len(x)
    ours = alimiter_compat(_t(x), SR).numpy()
    assert abs(np.abs(yf).max() - 1.0) < 2e-3
    assert abs(np.abs(ours).max() - 1.0) < 2e-3
    rms_db, lag = _aligned_diff(ours, yf)
    assert abs(lag - round(5 * SR / 1000)) <= 3
    assert rms_db < LIMITER_RMS_BOUND_DB[kind], (kind, rms_db)
