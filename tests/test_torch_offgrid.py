"""Track lengths off ame_tpu's bucket grid {2^k, 1.5 * 2^k} (ROADMAP C.1),
on the CPU. ame_tpu.api.master_array zero-pads a track to that grid, and
its compat loudnorm then takes its path and tail from the padded shape, so
on short off-grid tracks its masters differ from the chain on the true
length; the port never pads. The port's master_graph is held to
ame_tpu.graph.chain.master_graph on the unpadded track at a short
(100 003) and a long (150 001 samples, past RING + 1 loudnorm frames)
length in both modes, and the port's master_file to ame_tpu's at the long
length, where the padding changes nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch import api
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.io import wav as W

SR = 44100
SHORT, LONG = 100_003, 150_001
LSB = 1.0 / 32768.0
QUALITY = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
               width=1.2, lufs=-14.0)
COMPAT = dict(QUALITY, mode="compat", multiband=True)
MODES = {"quality": QUALITY, "compat": COMPAT}


def _track(mode: str, n: int) -> np.ndarray:
    """quality: 0.1 N(0,1) noise; compat: 0.3 noise + a 100 Hz tone gated
    at 2 Hz, every band over its threshold. Both on the int16 grid."""
    rng = np.random.default_rng(n)
    if mode == "quality":
        x = 0.1 * rng.standard_normal((n, 2))
    else:
        t = np.arange(n) / SR
        on = ((t % 0.5) < 0.25).astype(np.float64)[:, None]
        x = (0.3 * rng.standard_normal((n, 2))
             + 0.3 * np.sin(2 * np.pi * 100.0 * t)[:, None]) * on
    return (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(
        np.float32)


def _reference(x: np.ndarray, settings: dict):
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph as ref_master_graph
    y, info = ref_master_graph(jnp.asarray(x), float(SR),
                               RefSettings(**settings))
    return np.asarray(y), {k: float(v) for k, v in info.items()}


def _hold(mode: str, y: np.ndarray, y_ref: np.ndarray) -> None:
    """PERF.md section 2: quality <= 2e-4 abs; compat relative L2 < 3e-3
    or max abs <= 2 int16 LSB."""
    err = np.abs(y - y_ref).max()
    if mode == "quality":
        assert err <= 2e-4, err
    else:
        rel = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
        assert rel < 3e-3 or err <= 2 * LSB, (rel, err)


@pytest.mark.parametrize("n", [SHORT, LONG], ids=["short", "long"])
@pytest.mark.parametrize("mode", list(MODES))
def test_master_graph_off_grid_matches_reference(mode, n):
    x = _track(mode, n)
    y_ref, info_ref = _reference(x, MODES[mode])
    y, info = master_graph(torch.from_numpy(x), SR,
                           MasterSettings(**MODES[mode]))
    assert y.shape == (n, 2)
    _hold(mode, y.numpy(), y_ref)
    assert set(info) == set(info_ref)
    assert abs(float(info["gain_db"]) - info_ref["gain_db"]) <= 0.01
    assert abs(float(info["input_i"]) - info_ref["input_i"]) <= 0.01


@pytest.mark.parametrize("mode", list(MODES))
def test_master_file_long_off_grid_matches_reference(mode, tmp_path):
    """At 150 001 samples ame_tpu pads to 196 608 and its master still
    equals the unpadded chain's: the two master_files agree within 1 LSB
    (quality) / PERF.md section 2's compat gate on the int16 samples
    (relative L2 < 3e-3 or max <= 2 LSB; measured: 3 LSB at one sample,
    relative L2 1.5e-5), gain within 0.01 dB."""
    from ame_tpu.api import master_file as ref_master_file
    src = str(tmp_path / "in.wav")
    W.write_wav(src, _track(mode, LONG), SR)
    ref_out, out = str(tmp_path / "ref.wav"), str(tmp_path / "port.wav")
    info_ref = ref_master_file(src, ref_out, MODES[mode])
    info = api.master_file(src, out, MODES[mode], device="cpu")
    y_ref, _ = W.read_wav(ref_out, prefer_int16=True)
    y, _ = W.read_wav(out, prefer_int16=True)
    assert y.shape == y_ref.shape == (LONG, 2)
    if mode == "quality":
        lsb = np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max()
        assert lsb <= 1, lsb
    else:
        _hold(mode, y / 32768.0, y_ref / 32768.0)
    assert abs(info["gain_db"] - info_ref["gain_db"]) <= 0.01


def test_master_file_short_off_grid_is_the_unpadded_chain(tmp_path):
    """At 100 003 samples the port's compat master_file is ame_tpu's chain
    on the true length (its master_graph on the decoded track, quantized),
    not ame_tpu's padded master_file: within the compat gate of the
    former."""
    from ame_tpu_torch.ops.quantize import float_to_int16
    src, out = str(tmp_path / "in.wav"), str(tmp_path / "port.wav")
    W.write_wav(src, _track("compat", SHORT), SR)
    api.master_file(src, out, COMPAT, device="cpu")
    y, _ = W.read_wav(out, prefer_int16=True)
    x, _ = W.read_wav(src)
    y_ref, _ = _reference(x, COMPAT)
    want = float_to_int16(torch.from_numpy(y_ref.copy())).numpy()
    _hold("compat", y / 32768.0, want / 32768.0)
