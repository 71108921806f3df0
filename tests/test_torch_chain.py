"""The port's quality chain and API (ame_tpu_torch.graph.chain, .api) against
ame_tpu's on the same inputs, on the CPU."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu_torch import api
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph, params_from_settings
from ame_tpu_torch.io import wav as W
from tests.conftest import make_test_signal

SR = 44100
N = 1 << 16
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)


@pytest.mark.parametrize("settings", [FLAGSHIP, {}],
                         ids=["flagship", "defaults"])
def test_master_graph_matches_reference(settings):
    """Quality master_graph, port vs ame_tpu: output within 2e-4 abs,
    gain_db within 0.01 dB, on 0.1-scale stereo noise."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph as ref_master_graph
    x = (0.1 * np.random.default_rng(0).standard_normal((N, 2))
         ).astype(np.float32)
    y_ref, info_ref = ref_master_graph(jnp.asarray(x), float(SR),
                                       RefSettings(**settings))
    y, info = master_graph(torch.from_numpy(x), SR, MasterSettings(**settings))
    assert np.abs(y.numpy() - np.asarray(y_ref)).max() <= 2e-4
    assert abs(float(info["gain_db"]) - float(info_ref["gain_db"])) <= 0.01
    assert set(info) == set(info_ref)


def test_master_graph_timer_reports_stages():
    x = torch.from_numpy(make_test_signal("noise", N, SR) * 0.2)
    timer = {}
    master_graph(x, SR, MasterSettings(**FLAGSHIP), timer=timer)
    assert set(timer) == {"analog_eq_width", "loudnorm", "limiter"}
    assert all(v >= 0.0 for v in timer.values())


def test_params_from_numpy_carries_reference_params():
    """ame_tpu's params (f32 device scalars) -> numpy -> the port's params:
    the same keys, the f32 values, vectors as tensors on the device."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import params_from_settings as ref_params
    from ame_tpu_torch.convert import params_from_numpy
    ref = ref_params(RefSettings(**FLAGSHIP))
    got = params_from_numpy({k: np.asarray(v) for k, v in ref.items()},
                            "cpu")
    own = params_from_settings(MasterSettings(**FLAGSHIP))
    assert set(got) == set(own)
    for k, v in own.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v)
        else:
            assert got[k] == float(np.float32(v))


def test_master_file_matches_reference(tmp_path):
    """File to file on a 2^16-sample int16 WAV, the port on the CPU vs
    ame_tpu.api.master_file: int16 samples within +-1 LSB."""
    from ame_tpu.api import master_file as ref_master_file
    src = str(tmp_path / "in.wav")
    W.write_wav(src, make_test_signal("noise", N, SR) * 0.3, SR)
    ref_out, out = str(tmp_path / "ref.wav"), str(tmp_path / "port.wav")
    info_ref = ref_master_file(src, ref_out, FLAGSHIP)
    info = api.master_file(src, out, FLAGSHIP, device="cpu")
    y_ref, _ = W.read_wav(ref_out, prefer_int16=True)
    y, sr = W.read_wav(out, prefer_int16=True)
    assert sr == SR and y.shape == y_ref.shape == (N, 2)
    assert np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max() <= 1
    assert abs(info["gain_db"] - info_ref["gain_db"]) <= 0.01
    assert info["n_samples"] == N and info["sample_rate"] == SR


def test_master_array_rejects_non_int16_integers(tmp_path):
    """Integer input other than int16 has another scale; the port refuses
    it rather than treating it as float."""
    audio = np.zeros((4096, 2), np.int32)
    with pytest.raises(TypeError, match="int16"):
        api.master_array(audio, SR, str(tmp_path / "o.wav"), device="cpu")


class _Log:
    def __init__(self):
        self.status, self.progress, self.art, self.tags = [], [], [], []

    def cb(self):
        return (self.status.append,
                lambda c, t: self.progress.append((c, t)),
                self.art.append, self.tags.append)


def test_process_audio_success_contract(tmp_path):
    """Success: prefix, no Error:, one progress denominator from the first
    emission (num_chunks + 4) ending at (total, total), art None, the
    Musicologist's tag line, and the unported sidecars (MP3, art) reported
    as warnings."""
    src = str(tmp_path / "in.wav")
    W.write_wav(src, make_test_signal("noise", SR * 2, SR) * 0.2, SR)
    log = _Log()
    settings = {"input_file": src, "output_file": str(tmp_path / "m.wav"),
                "bass_boost": 1.0, "create_mp3": True,
                "auto_generate_prompt": True}
    api.process_audio(settings, *log.cb(), device="cpu")
    assert any(s.startswith("Success:") for s in log.status)
    assert not any(s.startswith("Error:") for s in log.status)
    assert len({t for _, t in log.progress}) == 1
    cur, total = log.progress[-1]
    assert cur == total == 1 + 4
    assert log.art == [None]
    assert os.path.exists(str(tmp_path / "m.wav"))
    warnings = [s for s in log.status if s.startswith("Warning:")]
    assert any("MP3" in s for s in warnings)
    assert any("art" in s for s in warnings)
    assert len(log.tags) == 1 and log.tags[0].startswith("Mood: ")
    assert "Analyzing audio with the Musicologist..." in log.status


def test_process_audio_manual_prompt_tags_like_reference(tmp_path):
    """With art_prompt set and auto_generate_prompt off, the port calls
    tag_callback exactly as ame_tpu.api.process_audio does ("Using manual
    prompt."), then reports art as not available and succeeds."""
    from ame_tpu.api import process_audio as ref_process_audio
    src = str(tmp_path / "in.wav")
    W.write_wav(src, make_test_signal("noise", SR, SR) * 0.2, SR)
    base = {"input_file": src, "create_mp3": False,
            "auto_generate_prompt": False, "art_prompt": "  a red sky  "}
    ref_log, log = _Log(), _Log()
    ref_process_audio(dict(base, output_file=str(tmp_path / "r.wav")),
                      *ref_log.cb())
    api.process_audio(dict(base, output_file=str(tmp_path / "p.wav")),
                      *log.cb(), device="cpu")
    assert ref_log.tags == ["Using manual prompt."]
    assert log.tags == ref_log.tags
    assert any(s.startswith("Warning:") and "art" in s for s in log.status)
    assert log.status[-1].startswith("Success:")


def test_process_audio_error_contract(tmp_path):
    """Missing input: Error: status, progress reset (0, 1), art None,
    'Processing failed.' tag."""
    log = _Log()
    settings = {"input_file": str(tmp_path / "nope.wav"),
                "output_file": str(tmp_path / "m.wav")}
    api.process_audio(settings, *log.cb(), device="cpu")
    assert any(s.startswith("Error:") for s in log.status)
    assert log.progress[-1] == (0, 1)
    assert log.art == [None]
    assert log.tags[-1] == "Processing failed."
