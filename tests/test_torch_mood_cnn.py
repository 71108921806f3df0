"""The port's mood CNN, its checkpoint reader and the analysis branch of
process_audio, against ame_tpu on the CPU."""

import hashlib
import os
import random

import msgpack
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from flax import serialization

from ame_tpu.analysis import musicologist as JM
from ame_tpu.creative import prompts as JP
from ame_tpu.io import wav as JW
from ame_tpu.models import mood_cnn as JC
from ame_tpu.models import synth_corpus
from ame_tpu_torch import convert
from ame_tpu_torch.analysis import musicologist as TM
from ame_tpu_torch.creative import prompts as TP
from ame_tpu_torch.models import _msgpack
from ame_tpu_torch.models import mood_cnn as TC

SR = 44100


def _assert_same_tree(got, want, where="root"):
    assert isinstance(got, dict) and isinstance(want, dict), where
    assert list(got) == list(want), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
        else:
            a, b = got[k], np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{where}/{k}"
            assert a.tobytes() == b.tobytes(), f"{where}/{k}"


# --- the checkpoint ----------------------------------------------------------

def test_weights_copy_is_byte_identical():
    def sha(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert sha(TC._DEFAULT_WEIGHTS) == sha(JC._DEFAULT_WEIGHTS)
    assert os.path.dirname(TC._DEFAULT_WEIGHTS).endswith(
        os.path.join("ame_tpu_torch", "models"))


def test_msgpack_reader_on_shipped_checkpoint():
    with open(TC._DEFAULT_WEIGHTS, "rb") as f:
        data = f.read()
    tree = _msgpack.load(TC._DEFAULT_WEIGHTS)
    _assert_same_tree(tree, serialization.msgpack_restore(data))
    assert sorted(tree) == ["Conv_0", "Conv_1", "Conv_2", "Dense_0",
                            "Dense_1"]
    assert sum(len(v) for v in tree.values()) == 10


def test_msgpack_reader_on_random_tree():
    """A tree written by flax.serialization.to_bytes: dtypes, 0-d and empty
    arrays, dims that need uint16 / uint32, fixext16 / ext8 / ext16 /
    ext32 leaves, map16 and str8 / str16 keys."""
    rng = np.random.default_rng(0)
    wide = {f"k{i:02d}": rng.standard_normal(3).astype(np.float32)
            for i in range(20)}
    tree = {
        "a": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
        "scalar": np.array(7, np.int32),
        "empty": np.zeros((0, 5), np.float32),
        "six_int8": np.arange(6, dtype=np.int8),            # fixext16
        "b": {"f64": rng.standard_normal(300).astype(np.float64),
              "u16": rng.integers(0, 60000, (2, 300)).astype(np.uint16),
              "i64": rng.integers(-5, 5, 70_000).astype(np.int64),
              "bool": rng.random(17) > 0.5,
              "f16": rng.standard_normal(9).astype(np.float16)},
        "wide": wide,
        "x" * 40: np.ones(2, np.float32),
        "y" * 300: np.full((1, 1), 3.0, np.float32),
    }
    data = serialization.to_bytes(tree)
    _assert_same_tree(_msgpack.unpackb(data),
                      serialization.msgpack_restore(data))


def test_msgpack_reader_container_types_and_refusals():
    """The remaining container forms (map32, array16, str32, bin, uint32)
    decode as msgpack does; types a checkpoint does not use raise."""
    doc = {"m": {f"{i}": i for i in range(70_000)},
           "arr": list(range(20)), "s": "z" * 70_000,
           "bin": b"\x00\x01" * 40_000, "u": 4_000_000_000}
    data = msgpack.packb(doc, use_bin_type=True)
    assert _msgpack.unpackb(data) == msgpack.unpackb(data, raw=False)
    for bad in (msgpack.packb(None), msgpack.packb(-3), msgpack.packb(1.5),
                msgpack.packb({1: 2}), msgpack.packb({"a": 1}) + b"\x00",
                msgpack.packb(msgpack.ExtType(2, b"xx"))):
        with pytest.raises(ValueError):
            _msgpack.unpackb(bad)


# --- the network -------------------------------------------------------------

def _port_model(params):
    model = TC.MoodCNN()
    model.load_state_dict(convert.mood_cnn_state_dict(
        {k: {n: np.asarray(a) for n, a in v.items()}
         for k, v in params.items()}))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def shipped():
    params, trained = JC.load_params()
    assert trained
    return params


def test_state_dict_layouts(shipped):
    sd = convert.mood_cnn_state_dict(
        {k: {n: np.asarray(a) for n, a in v.items()}
         for k, v in shipped.items()})
    assert sd.keys() == TC.MoodCNN().state_dict().keys()
    k = np.asarray(shipped["Conv_1"]["kernel"])               # HWIO
    assert sd["convs.1.weight"].shape == (64, 32, 3, 3)       # OIHW
    assert sd["convs.1.weight"][5, 7, 2, 1] == k[2, 1, 7, 5]
    d = np.asarray(shipped["Dense_1"]["kernel"])              # [in, out]
    assert sd["dense1.weight"].shape == (4, 128)
    assert sd["dense1.weight"][3, 100] == d[100, 3]


def test_logits_match_predict_logits(shipped):
    """Random images (seed 0): atol 1e-4 (measured 1.7e-5), argmax
    equal."""
    imgs = np.random.default_rng(0).random((4, 128, 128, 3)).astype(
        np.float32)
    want = np.asarray(JC.predict_logits(shipped, jnp.asarray(imgs)))
    got = _port_model(shipped)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.array_equal(got.argmax(1), want.argmax(1))


def test_load_params_reads_the_packages_checkpoint(shipped):
    model, trained = TC.load_params(device="cpu")
    assert trained
    assert TC.load_params(device="cpu")[0] is model
    ref = _port_model(shipped).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_load_params_without_checkpoint(tmp_path):
    """A missing checkpoint gives seeded untrained weights: trained False,
    the same weights on every build."""
    path = str(tmp_path / "none.msgpack")
    model, trained = TC.load_params(path, device="cpu")
    assert not trained
    again = TC.init_params(0)
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    TC._cache.pop((os.path.abspath(path), "cpu"))


@pytest.mark.parametrize("cls", JC.MOOD_CLASSES)
def test_synth_track_mood_matches_reference(shipped, cls):
    """One synth_corpus track per class (seed 4242), each package's image
    and CNN: mood equal, logits atol 1e-4 (measured 4.2e-6)."""
    rng = np.random.default_rng(4242)
    y = synth_corpus.synth_track(cls, rng, seconds=30.0)[:, 0]
    want = np.asarray(JC.predict_logits(
        shipped, JM.spectrogram_image(jnp.asarray(y))[None]))[0]
    model, _ = TC.load_params(device="cpu")
    got = model(TM.spectrogram_image(torch.from_numpy(y))[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert TC.MOOD_CLASSES[got.argmax()] == JC.MOOD_CLASSES[want.argmax()]


# --- prompts and process_audio -----------------------------------------------

@pytest.mark.parametrize("brief", [
    {"mood": "Happy/Excited", "tempo": "128 BPM (fast)",
     "brightness": "bright", "density": "dense", "key": "C major"},
    {"mood": "Sad/Depressed", "tempo": "70 BPM (slow)",
     "brightness": "dark", "density": "sparse"},
    {"mood": "Calm/Content", "tempo": "??", "brightness": "warm",
     "density": "moderate"},
], ids=["full", "no_key", "fallback"])
def test_creative_prompt_matches_reference(brief):
    assert TP.generate_creative_prompt(brief, random.Random(0)) == \
        JP.generate_creative_prompt(brief, random.Random(0))
    assert TP.PROMPT_LIBRARY == JP.PROMPT_LIBRARY


class _Log:
    def __init__(self):
        self.status, self.progress, self.art, self.tags = [], [], [], []

    def cb(self):
        return (self.status.append,
                lambda c, t: self.progress.append((c, t)),
                self.art.append, self.tags.append)


def _run_both(tmp_path, src):
    from ame_tpu.api import process_audio as ref_process_audio
    from ame_tpu_torch import api
    base = {"input_file": src, "create_mp3": False,
            "auto_generate_prompt": True}
    ref_log, log = _Log(), _Log()
    ref_process_audio(dict(base, output_file=str(tmp_path / "r.wav")),
                      *ref_log.cb())
    api.process_audio(dict(base, output_file=str(tmp_path / "p.wav")),
                      *log.cb(), device="cpu")
    return ref_log, log


def test_process_audio_analysis_tags_like_reference(tmp_path, monkeypatch):
    """auto_generate_prompt: the same tag sequence as ame_tpu's
    process_audio (the Musicologist's tag line), then the prompt step and a
    Success: status, no Error: / Failed:."""
    monkeypatch.delenv("AME_TPU_ART_PROVIDER", raising=False)
    src = str(tmp_path / "in.wav")
    x = 0.2 * np.random.default_rng(3).standard_normal((2 * SR, 2))
    JW.write_wav(src, x.astype(np.float32), SR)
    ref_log, log = _run_both(tmp_path, src)
    assert len(ref_log.tags) == 1 and ref_log.tags[0].startswith("Mood: ")
    assert log.tags == ref_log.tags
    i = log.status.index("Analyzing audio with the Musicologist...")
    assert log.status[i + 1] == "Building creative prompt from analysis..."
    assert log.status[-1].startswith("Success:")
    assert not any(s.startswith(("Error:", "Failed:")) for s in log.status)


def test_process_audio_analysis_error_tags_like_reference(tmp_path,
                                                          monkeypatch):
    """An analysis error dict gives the same 'Analysis Error:' tag in both
    packages and a Failed: status; the master still succeeds."""
    err = {"error": "decoder exploded"}
    monkeypatch.setattr(JM, "analyze_song", lambda *a, **k: err)
    monkeypatch.setattr(TM, "analyze_song", lambda *a, **k: err)
    src = str(tmp_path / "in.wav")
    JW.write_wav(src, 0.1 * np.ones((SR, 2), np.float32), SR)
    ref_log, log = _run_both(tmp_path, src)
    assert ref_log.tags == ["Analysis Error: decoder exploded"]
    assert log.tags == ref_log.tags
    assert "Failed: Could not analyze audio. decoder exploded" in log.status
    assert log.status[-1] == "Success: Processing complete! (No art generated)"
    assert os.path.exists(str(tmp_path / "p.wav"))
