"""The port's channel-stacked fleet batch (ame_tpu_torch.parallel.stacked) on
the CPU: each public function against ame_tpu.parallel.stacked's on the
same numpy input at B = 1 and 3 (the third track of 3 silent: quirk Q9),
and master_batch_stacked against the port's own master_graph track by
track.

Tolerances against ame_tpu: the width 1e-6 (the same float32 arithmetic);
the compressor, the multiband stage, the normalizer and the whole batch
2e-4 absolute, the quality parity gate of PERF.md section 2 (ame_tpu
designs the RBJ and crossover coefficients in float32, the port in
float64); the loudness 0.01 LU and the true peak 0.01 dB; the limiter
1e-5, as tests/test_torch_ops.py holds the single-track one. Against
master_graph: tests/test_parallel.py's atol 5e-5, rtol 1e-4 (the same
cascades on other column counts, other reduction orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu.parallel import stacked as ref
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.parallel import stacked

SR = 44100
N = 1 << 15
QUALITY_MB = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                  width=1.2, lufs=-14.0, multiband=True)
THRESHS, RATIOS = (-24.0, -20.0, -18.0), (4.0, 3.0, 2.5)


def _tracks(b: int, n: int = N) -> np.ndarray:
    """[b, n, 2]: noise at three levels, the channels decorrelated so that
    the width and the channel link matter; of three, the last is silent."""
    rng = np.random.default_rng(20 + b)
    xs = rng.standard_normal((b, n, 2)) * np.array([0.3, 0.1, 0.2])[:b,
                                                                    None,
                                                                    None]
    xs[:, :, 1] = 0.8 * xs[:, :, 1] + 0.3 * xs[:, :, 0]
    if b == 3:
        xs[2] = 0.0
    return xs.astype(np.float32)


def _stack(xs: np.ndarray) -> np.ndarray:
    b, n, _ = xs.shape
    return np.ascontiguousarray(np.moveaxis(xs, 0, 1).reshape(n, 2 * b))


def _both(xs):
    x = _stack(xs)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("b", [1, 3])
def test_stereo_width_stacked(b):
    t, j = _both(_tracks(b))
    got = stacked.stereo_width_stacked(t, 1.3).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.stereo_width_stacked(
        j, 1.3)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("b", [1, 3])
def test_compress_quality_multi_stacked(b):
    """The three bands of the crossover (the port's, as numpy, into both)
    through the stacked compressor, the level over every threshold."""
    t, _ = _both(_tracks(b))
    from ame_tpu_torch.graph.multiband import quality_band_split
    bands = quality_band_split(t, SR)
    got = stacked.compress_quality_multi_stacked(
        bands, SR, THRESHS, RATIOS, attack_ms=5.0, release_ms=80.0)
    want = ref.compress_quality_multi_stacked(
        [jnp.asarray(x.numpy()) for x in bands], SR, THRESHS, RATIOS,
        attack_ms=5.0, release_ms=80.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)
    # the compressor reduced the loud track's level
    assert np.abs(got[1].numpy()[:, :2]).max() < np.abs(
        bands[1].numpy()[:, :2]).max()


@pytest.mark.parametrize("b", [1, 3])
def test_multiband_quality_stacked(b):
    t, j = _both(_tracks(b))
    got = stacked.multiband_quality_stacked(t, SR, torch.tensor(THRESHS),
                                            torch.tensor(RATIOS))
    want = ref.multiband_quality_stacked(j, SR, jnp.asarray(THRESHS),
                                         jnp.asarray(RATIOS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("b", [1, 3])
def test_measure_stacked(b):
    """Per-track loudness and true peak; the silent track reads -inf in
    both packages."""
    t, j = _both(_tracks(b))
    integ, tp = stacked.measure_stacked(t, SR)
    want_i, want_tp = (np.asarray(v) for v in ref.measure_stacked(j, SR))
    assert integ.shape == tp.shape == (b,)
    finite = np.isfinite(want_i)
    assert (np.isfinite(integ.numpy()) == finite).all()
    assert finite.sum() == min(b, 2)
    np.testing.assert_allclose(integ.numpy()[finite], want_i[finite],
                               rtol=0, atol=0.01)
    np.testing.assert_allclose(tp.numpy(), want_tp, rtol=0, atol=0.01)


@pytest.mark.parametrize("b", [1, 3])
def test_normalize_stacked(b):
    t, j = _both(_tracks(b))
    got = stacked.normalize_stacked(t, SR, -14.0).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.normalize_stacked(
        j, SR, -14.0)), rtol=0, atol=2e-4)
    if b == 3:                       # quirk Q9: the silent track stays 0
        assert not got[:, 4:].any()


@pytest.mark.parametrize("b", [1, 3])
def test_limiter_stacked(b):
    """Tracks driven 4x over the ceiling: each limited with its own
    channel-linked gain."""
    xs = _tracks(b) * 4.0
    t, j = _both(xs)
    got = stacked.limiter_stacked(t, SR).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.limiter_stacked(j, SR)),
                               rtol=0, atol=1e-5)
    assert np.abs(got).max() <= 0.98 + 1e-5


@pytest.mark.parametrize("b", [1, 3])
def test_master_batch_stacked_matches_ame_tpu(b):
    xs = _tracks(b)
    got = stacked.master_batch_stacked(xs, SR, QUALITY_MB, device="cpu")
    want = np.asarray(ref.master_batch_stacked(xs, SR, MasterSettings(
        **QUALITY_MB)))
    assert got.shape == xs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("settings", [
    QUALITY_MB, dict(bass_boost=-1.0, treble_boost=2.0, lufs=None),
    dict(QUALITY_MB, width=1.0, analog_character=0.0)],
    ids=["flagship_mb", "no_lufs", "no_width_no_analog"])
def test_master_batch_stacked_matches_master_graph(settings):
    """Each track of a batch of 3 (one silent) within atol 5e-5, rtol 1e-4
    of the port's master_graph on that track alone."""
    xs = _tracks(3)
    got = stacked.master_batch_stacked(torch.from_numpy(xs), SR, settings,
                                       device="cpu")
    for i in range(3):
        want, _ = master_graph(torch.from_numpy(xs[i]), SR,
                               MasterSettings(**settings))
        torch.testing.assert_close(got[i], want, rtol=1e-4, atol=5e-5)
    assert not got[2].any()


@pytest.mark.parametrize("layout", ["tracks", "stacked"])
def test_master_batch_stacked_keeps_the_shape(layout):
    """[B, N, 2] comes back [B, N, 2]; [N, 2B] comes back [N, 2B], the same
    masters in the other layout."""
    xs = _tracks(3, 1 << 13)
    x = xs if layout == "tracks" else _stack(xs)
    got = stacked.master_batch_stacked(x, SR, QUALITY_MB, device="cpu")
    assert tuple(got.shape) == x.shape and got.dtype == torch.float32
    other = stacked.master_batch_stacked(
        _stack(xs) if layout == "tracks" else xs, SR, QUALITY_MB,
        device="cpu")
    if layout == "tracks":
        got, other = other, got
    torch.testing.assert_close(got, torch.from_numpy(_stack(
        other.numpy())), rtol=0, atol=0)


def test_master_batch_stacked_refuses_g_bands_and_missing_card(monkeypatch):
    xs = _tracks(1, 4096)
    with pytest.raises(NotImplementedError, match="G-band"):
        stacked.master_batch_stacked(
            xs, SR, dict(QUALITY_MB, mb_edges=(200.0, 2000.0, 8000.0)),
            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stacked.master_batch_stacked(xs, SR, QUALITY_MB)
