"""The mood CNN's evaluation corpora through the port on the CPU: the
port's copies of the out-of-family and third-family generators
(ame_tpu_torch.models.oof_corpus / oof2_corpus) equal ame_tpu's bit for
bit, predict_mood equals ame_tpu's, and the shipped weights classify both
families with tests/test_mood_model.py:40-84's protocol (seed 77, 4 tracks
a class, 20 s) at its floor of 0.75."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch.analysis import musicologist as M
from ame_tpu_torch.models import mood_cnn, oof2_corpus, oof_corpus

FAMILIES = {"oof": (oof_corpus.synth_track_oof, "synth_track_oof"),
            "oof2": (oof2_corpus.synth_track_oof2, "synth_track_oof2")}


def _ref_family(name):
    from ame_tpu.models import oof2_corpus as ref2
    from ame_tpu.models import oof_corpus as ref1
    return getattr({"oof": ref1, "oof2": ref2}[name], FAMILIES[name][1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_corpus_equals_reference_bit_for_bit(family):
    """The same rng seed gives the same tracks, class by class, in
    sequence (the rng state carries from one track to the next)."""
    port, ref = FAMILIES[family][0], _ref_family(family)
    rng_p, rng_r = np.random.default_rng(5), np.random.default_rng(5)
    for cls in mood_cnn.MOOD_CLASSES:
        a = port(cls, rng_p, seconds=3.0)
        b = ref(cls, rng_r, seconds=3.0)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert port.__module__.startswith("ame_tpu_torch.")


def test_predict_mood_matches_reference():
    """Four images, one a class: the port's predict_mood (batch of 1,
    argmax, class name) names the class ame_tpu's does on the same image
    and weights."""
    from ame_tpu.models import mood_cnn as ref_mood
    model, trained = mood_cnn.load_params(device="cpu")
    params, ref_trained = ref_mood.load_params()
    assert trained and ref_trained
    rng = np.random.default_rng(77)
    for cls in mood_cnn.MOOD_CLASSES:
        y = oof_corpus.synth_track_oof(cls, rng, seconds=6.0)
        img = M.spectrogram_image(torch.from_numpy(
            np.ascontiguousarray(y[:, 0])))
        assert img.shape == (128, 128, 3)
        got = mood_cnn.predict_mood(model, img)
        assert got in mood_cnn.MOOD_CLASSES
        assert got == ref_mood.predict_mood(params, jnp.asarray(img.numpy()))


def _family_confusion(synth, seed=77, per_class=4):
    model, trained = mood_cnn.load_params(device="cpu")
    assert trained
    rng = np.random.default_rng(seed)
    conf = np.zeros((4, 4), int)
    classes = mood_cnn.MOOD_CLASSES
    for ci, cls in enumerate(classes):
        for _ in range(per_class):
            y = synth(cls, rng, seconds=20.0)
            img = M.spectrogram_image(torch.from_numpy(
                np.ascontiguousarray(y[:, 0])))
            conf[ci, classes.index(mood_cnn.predict_mood(model, img))] += 1
    return conf


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_accuracy(family):
    """Out-of-family (Karplus-Strong, FM, noise percussion) and third-family
    (subtractive sweeps, granular clouds, formants) tracks classify at or
    above 0.75 through the port's spectrogram image and model."""
    conf = _family_confusion(FAMILIES[family][0])
    acc = np.trace(conf) / conf.sum()
    assert acc >= 0.75, f"{family} accuracy {acc}\n{conf}"
