"""The port's compat chain (ame_tpu_torch.graph.chain with mode="compat",
and the API around it) against ame_tpu's on the same inputs, on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch import api
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.io import wav as W

SR = 44100
N = 1 << 16
FLAGSHIP = dict(mode="compat", analog_character=20.0, bass_boost=2.0,
                presence_boost=1.5, width=1.2, lufs=-14.0)


def _gated_program(n, seed=0):
    """0.3 noise + a 100 Hz tone at 0.3, switched on and off at 2 Hz and
    put on the int16 grid: loud enough for every band to cross its
    compressor threshold while on."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    on = ((t % 0.5) < 0.25).astype(np.float64)[:, None]
    x = (0.3 * rng.standard_normal((n, 2))
         + 0.3 * np.sin(2 * np.pi * 100.0 * t)[:, None]) * on
    return (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(
        np.float32)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


@pytest.mark.parametrize("settings", [
    FLAGSHIP,
    dict(FLAGSHIP, multiband=True),
    dict(mode="compat", multiband=True, bass_boost=-2.0, mid_cut=3.0,
         treble_boost=-4.0, lufs=None),
], ids=["flagship", "flagship_multiband", "negative_q1_multiband"])
def test_compat_master_graph_matches_reference(settings):
    """Port vs ame_tpu: tests/test_chain.py's compat gate (relative L2 <
    3e-3 or max abs <= 2 int16 LSB, counted at the limiter's input: its
    auto-level scales the output by 1/0.98) and gain_db within 0.01 dB.
    The Q1 preset annihilates most of the signal, so only the LSB arm
    can hold there."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph as ref_master_graph
    x = _gated_program(N)
    y_ref, info_ref = ref_master_graph(jnp.asarray(x), float(SR),
                                       RefSettings(**settings))
    y, info = master_graph(torch.from_numpy(x), SR,
                           MasterSettings(**settings))
    y_ref = np.asarray(y_ref)
    max_abs = np.abs(y.numpy() - y_ref).max()
    assert (_rel_err(y.numpy(), y_ref) < 3e-3
            or max_abs <= 2.0 / 32768.0 / 0.98), max_abs
    assert set(info) == set(info_ref)
    if settings.get("lufs", -14.0) is not None:
        assert abs(float(info["gain_db"]) - float(info_ref["gain_db"])) \
            <= 0.01
        assert float(info["linear_mode"]) == float(info_ref["linear_mode"])


def test_compat_multiband_engages_every_band():
    """The gated program drives every band of the exact compressor above
    its threshold: the chain's input to the gain engine is non-zero in all
    three bands."""
    from ame_tpu_torch.graph.multiband import _crossover_compat
    from ame_tpu_torch.ops import compressor, quantize
    x = torch.from_numpy(_gated_program(1 << 15))
    bands = _crossover_compat(x, SR)
    for band, th, ra in zip(bands, (-25.0, -20.0, -15.0), (6.0, 3.0, 4.0)):
        _, m, _ = compressor.pydub_detector(quantize.float_to_int16(band), SR,
                                            th, ra)
        assert m.max() > 0.0


def test_compat_timer_reports_stages():
    x = torch.from_numpy(_gated_program(1 << 14))
    timer = {}
    master_graph(x, SR, MasterSettings(**dict(FLAGSHIP, multiband=True)),
                 timer=timer)
    assert set(timer) == {"analog", "eq_width", "multiband", "loudnorm",
                          "limiter"}
    assert all(v >= 0.0 for v in timer.values())


def test_compat_rejects_band_edges():
    """G-band edges are quality-mode only, in the reference and here."""
    with pytest.raises(ValueError, match="quality-mode only"):
        master_graph(torch.zeros(4096, 2), SR,
                     MasterSettings(mode="compat", mb_edges=(250.0, 2000.0)))


def test_compat_master_file_matches_reference(tmp_path):
    """File to file on a 2^16-sample int16 WAV: the port on the CPU vs
    ame_tpu.api.master_file, int16 samples within +-2 LSB, gain within
    0.01 dB."""
    from ame_tpu.api import master_file as ref_master_file
    settings = dict(FLAGSHIP, multiband=True)
    src = str(tmp_path / "in.wav")
    W.write_wav(src, _gated_program(N, seed=1), SR)
    ref_out, out = str(tmp_path / "ref.wav"), str(tmp_path / "port.wav")
    info_ref = ref_master_file(src, ref_out, settings)
    info = api.master_file(src, out, settings, device="cpu")
    y_ref, _ = W.read_wav(ref_out, prefer_int16=True)
    y, sr = W.read_wav(out, prefer_int16=True)
    assert sr == SR and y.shape == y_ref.shape == (N, 2)
    assert np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max() <= 2
    assert abs(info["gain_db"] - info_ref["gain_db"]) <= 0.01


def test_compat_master_array_puts_input_on_the_int16_grid(tmp_path):
    """Compat mode quantizes the staged input to the int16 grid before the
    graph (engine:190-191), float or int16 alike, as ame_tpu's master_array
    does: off-grid float input masters as the reference's, within +-2
    LSB, and unlike the graph run on the raw floats."""
    from ame_tpu.api import master_array as ref_master_array
    x = np.clip(make_noise(1 << 14), -1, 1).astype(np.float32)
    settings = dict(FLAGSHIP, lufs=None)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    ref_master_array(x, SR, a, settings)
    api.master_array(x, SR, b, settings, device="cpu")
    ya, _ = W.read_wav(a, prefer_int16=True)
    yb, _ = W.read_wav(b, prefer_int16=True)
    assert np.abs(ya.astype(np.int32) - yb.astype(np.int32)).max() <= 2
    raw, _ = master_graph(torch.from_numpy(x), SR, MasterSettings(**settings))
    from ame_tpu_torch.ops.quantize import float_to_int16
    assert not np.array_equal(float_to_int16(raw).numpy(), yb)


def make_noise(n, seed=5):
    return 0.3 * np.random.default_rng(seed).standard_normal((n, 2))
