"""The port's quality-chain ops (ame_tpu_torch.ops) against their ame_tpu
counterparts on the same numpy inputs, plus the BS.1770 sine anchors of
tests/test_loudness.py applied to the port. All on the CPU (plain PyTorch
versions)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch.ops import (eq, limiter, loudness, quantize, saturate,
                               stereo, window)
from tests.conftest import make_test_signal

SR = 44100


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.abs(got - np.asarray(want)).max() <= atol


# ---------------------------------------------------------------------------
# Pre-stage: EQ, analog character, width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gains", [(2.0, 0.0, 1.5, 0.0),
                                   (-3.0, 2.0, -1.0, 4.0)])
def test_apply_eq_quality_matches_reference(gains):
    """The port designs the RBJ coefficients in float64 on the host, the
    reference in f32 in-graph; their f32 rounding (~6e-8 relative) moves the
    250 Hz shelf's output by ~1e-5 on 0.3-scale noise. So: within 5e-5 of
    the reference, and within 1e-6 of float64 scipy on the same design."""
    from scipy.signal import sosfilt as scipy_sosfilt
    from ame_tpu.ops.eq import apply_eq_quality as ref
    x = make_test_signal("noise", 1 << 14, SR)
    want = ref(jnp.asarray(x), float(SR), *(jnp.float32(g) for g in gains))
    got = eq.apply_eq_quality(_t(x), SR, *gains)
    _close(got, want, 5e-5)
    exact = scipy_sosfilt(eq.eq_quality_sos(SR, *gains),
                          x.astype(np.float64), axis=0)
    _close(got, exact, 1e-6)


@pytest.mark.parametrize("percent", [20.0, 100.0])
def test_analog_character_quality_matches_reference(percent):
    """tanh drive + k=2 shelf cascade. The reference designs the shelves in
    f32 in-graph: a coefficient error eps ~ 6e-8 moves a shelf whose poles
    sit at radius r by about eps / (1 - r)^2 ~ 2e-4 at 120 Hz (r ~ 0.983),
    which a sweep's low end exposes. So: within 3e-4 of the reference, and
    within 1e-6 of float64 scipy on the port's float64 design."""
    from scipy.signal import sosfilt as scipy_sosfilt
    from ame_tpu.ops.saturate import analog_character_quality as ref
    x = make_test_signal("sweep", 1 << 14, SR)
    want = ref(jnp.asarray(x), float(SR), jnp.float32(percent))
    got = saturate.analog_character_quality(_t(x), SR, percent)
    _close(got, want, 3e-4)
    drive = 1.0 + percent / 100.0 * 0.5
    exact = scipy_sosfilt(saturate.analog_sos(SR, percent),
                          np.tanh(x.astype(np.float64) * drive), axis=0)
    _close(got, exact, 1e-6)


@pytest.mark.parametrize("width", [0.0, 1.2, 2.0])
def test_stereo_width_quality_matches_reference(width):
    """Pure elementwise M/S math: within 1e-7 abs."""
    from ame_tpu.ops.stereo import stereo_width_quality as ref
    x = make_test_signal("noise", 1 << 12, SR)
    want = ref(jnp.asarray(x), jnp.float32(width))
    _close(stereo.stereo_width_quality(_t(x), width), want, 1e-7)


# ---------------------------------------------------------------------------
# Loudness
# ---------------------------------------------------------------------------

def _dynamic_program(sr):
    """Quiet then loud noise, long enough for several 3 s LRA blocks."""
    n = (1 << 17) // 2
    quiet = make_test_signal("noise", n, sr, seed=1) * 0.05
    loud = make_test_signal("noise", n, sr, seed=2) * 0.4
    return np.concatenate([quiet, loud])


@pytest.mark.parametrize("n_valid", [None, 100_000])
def test_measure_matches_reference(n_valid):
    """input_i / input_lra / input_thresh within 0.01 dB, input_tp within
    0.02 dB (the reference's bf16 true-peak bound), at 16 kHz so 2^17
    samples hold 8 s of LRA blocks; n_valid masks the gating blocks."""
    from ame_tpu.ops.loudness import measure as ref
    sr = 16000
    x = _dynamic_program(sr)
    want = ref(jnp.asarray(x), sr,
               None if n_valid is None else jnp.int32(n_valid))
    got = loudness.measure(_t(x), sr, n_valid)
    assert float(want["input_lra"]) > 5.0   # the LRA gate is exercised
    for key, tol in (("input_i", 0.01), ("input_lra", 0.01),
                     ("input_thresh", 0.01), ("input_tp", 0.02)):
        assert abs(float(got[key]) - float(want[key])) <= tol, key


def test_true_peak_matches_reference_on_intersample_tone():
    """An fs/4 tone with unlucky phase: the 4x meter sees the intersample
    crest; port and reference agree within 0.02 dB."""
    from ame_tpu.ops.loudness import true_peak_db as ref
    t = np.arange(1 << 14) / SR
    x = np.sin(2 * np.pi * 11025 * t + np.pi / 4).astype(np.float32)
    x = np.stack([x, x], axis=1)
    got = float(loudness.true_peak_db(_t(x)))
    assert got > 20 * np.log10(np.abs(x).max()) + 0.05
    assert abs(got - float(ref(jnp.asarray(x)))) <= 0.02


def test_normalize_two_pass_matches_reference():
    """Output within 2e-5 abs and gain within 0.01 dB; silence passes
    through unchanged (quirk Q9)."""
    from ame_tpu.ops.loudness import normalize_two_pass as ref
    x = make_test_signal("noise", 1 << 16, SR) * 0.05
    y_ref, info_ref = ref(jnp.asarray(x), SR, -14.0)
    y, info = loudness.normalize_two_pass(_t(x), SR, -14.0)
    _close(y, y_ref, 2e-5)
    assert abs(float(info["gain_db"]) - float(info_ref["gain_db"])) <= 0.01
    silent = np.zeros((SR, 2), np.float32)
    y_sil, info_sil = loudness.normalize_two_pass(_t(silent), SR, -14.0)
    assert np.array_equal(y_sil.numpy(), silent)
    assert float(info_sil["gain_db"]) == 0.0


def test_bs1770_sine_anchor():
    """BS.1770 anchor: a 0 dBFS 997 Hz sine in ONE channel reads -3.01 LKFS,
    the same tone in BOTH channels 0.0 LKFS (within 0.05)."""
    sr = 48000
    t = np.arange(2 * sr) / sr
    tone = np.sin(2 * np.pi * 997.0 * t).astype(np.float32)
    mono_left = np.stack([tone, np.zeros_like(tone)], axis=1)
    both = np.stack([tone, tone], axis=1)
    assert abs(float(loudness.measure(_t(mono_left), sr)["input_i"])
               + 3.01) < 0.05
    assert abs(float(loudness.measure(_t(both), sr)["input_i"])) < 0.05


def test_silence_is_neg_inf():
    x = np.zeros((SR, 2), np.float32)
    assert float(loudness.measure(_t(x), SR)["input_i"]) == -np.inf


@pytest.mark.parametrize("kind", ["highpass", "lowpass"])
@pytest.mark.parametrize("f0,q", [(30.0, 0.7071), (12000.0, 2.0)])
def test_rbj_pass_designs_match_reference(kind, f0, q):
    """The port's float64 RBJ high- and low-pass biquads equal ame_tpu's
    (both numpy float64 on the host)."""
    from ame_tpu.dsp import design as ref
    from ame_tpu_torch.dsp import design
    got = getattr(design, f"rbj_{kind}")(f0, SR, q)
    want = getattr(ref, f"rbj_{kind}")(f0, SR, q)
    assert got.shape == (1, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Windows and limiter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 220, 1000])
def test_sliding_min_ahead_matches_reference(w):
    from ame_tpu.ops.window import sliding_min_ahead as ref
    x = np.random.default_rng(5).random(5000).astype(np.float32)
    _close(window.sliding_min_ahead(_t(x), w), ref(jnp.asarray(x), w), 1e-5)


@pytest.mark.parametrize("w", [1, 220, 1000])
def test_sliding_max_ahead_matches_reference(w):
    from ame_tpu.ops.window import sliding_max_ahead as ref
    x = np.random.default_rng(8).standard_normal((5000, 2)).astype(
        np.float32)
    got = window.sliding_max_ahead(_t(x), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref(jnp.asarray(x), w)))


@pytest.mark.parametrize("w", [220, 2000])
def test_moving_mean_past_matches_reference(w):
    """Both moving-sum routes: the tile band (w <= 1024) and the van Herk
    block scans (larger w)."""
    from ame_tpu.ops.window import moving_mean_past as ref
    x = np.random.default_rng(6).random(7000).astype(np.float32)
    _close(window.moving_mean_past(_t(x), w), ref(jnp.asarray(x), w), 1e-5)


@pytest.mark.parametrize("decay", [0.99, 0.9995])
def test_release_scan_matches_reference(decay):
    from ame_tpu.ops.window import release_scan as ref
    u = np.random.default_rng(7).random((6000, 2)).astype(np.float32) ** 8
    want = ref(jnp.asarray(u), jnp.float32(decay))
    _close(window.release_scan(_t(u), decay), want, 1e-5)


def test_lookahead_limiter_matches_reference():
    """A hot signal that the limiter must pull under 0.98: output and gain
    within 1e-5 of the reference, ceiling held."""
    from ame_tpu.ops.limiter import lookahead_limiter as ref
    x = make_test_signal("noise", 1 << 15, SR) * 4.0
    y_ref, g_ref = ref(jnp.asarray(x), SR, return_gain=True)
    y, g = limiter.lookahead_limiter(_t(x), SR, return_gain=True)
    _close(y, y_ref, 1e-5)
    _close(g, g_ref, 1e-5)
    assert float(y.abs().max()) <= 0.98 + 1e-5


def test_float_to_int16_matches_reference_exactly():
    from ame_tpu.ops.quantize import float_to_int16 as ref
    x = np.concatenate([np.linspace(-1.5, 1.5, 4001, dtype=np.float32),
                        np.float32([-1.0, 1.0, 0.0, 1 / 32767, -1 / 32767])])
    x = np.stack([x, -x], axis=1)
    got = quantize.float_to_int16(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(ref(jnp.asarray(x))))
