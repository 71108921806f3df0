"""The port's Musicologist against ame_tpu's on the CPU: the resampler, the
STFT / mel stack, the features, the spectrogram image and the brief, on
the same seeded numpy inputs through both packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ame_tpu.analysis import features as JF
from ame_tpu.analysis import musicologist as JM
from ame_tpu.analysis import stft as JS
from ame_tpu.io import wav as JW
from ame_tpu.ops import resample as JR
from ame_tpu_torch.analysis import features as TF
from ame_tpu_torch.analysis import musicologist as TM
from ame_tpu_torch.analysis import stft as TS
from ame_tpu_torch.ops import resample as TR

ASR = 22050
WINDOW = int(30 * ASR)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _noise(n, seed=2, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


def _click_track(bpm, seconds=30, sr=ASR):
    """tests/test_analysis.py's click track, with a 1 kHz tone under each
    click."""
    n = int(seconds * sr)
    y = np.zeros(n, np.float32)
    period = int(60 / bpm * sr)
    tone = (np.hanning(80) * np.sin(2 * np.pi * 1000 * np.arange(80) / sr)
            ).astype(np.float32)
    for i in range(0, n - 80, period):
        y[i:i + 80] += np.hanning(80).astype(np.float32) * 0.5 + 0.4 * tone
    return y


def _key_chords(seconds=6.0, sr=float(ASR)):
    """test_analysis.py:178's synthetic C major and A minor chords."""
    t = np.arange(int(seconds * sr)) / sr

    def tone(midi, amp):
        return amp * np.sin(2 * np.pi * 440.0 * 2 ** ((midi - 69) / 12.0) * t)

    cmaj = (tone(60, 1.0) + tone(64, 0.55) + tone(67, 0.65)
            + tone(72, 0.5) + tone(48, 0.7) + tone(62, 0.2)
            + tone(65, 0.2) + tone(69, 0.2) + tone(71, 0.2))
    amin = (tone(57, 1.0) + tone(60, 0.55) + tone(64, 0.65)
            + tone(69, 0.5) + tone(45, 0.7) + tone(59, 0.2)
            + tone(62, 0.2) + tone(65, 0.2) + tone(67, 0.2))
    return [(0.1 * cmaj).astype(np.float32), (0.1 * amin).astype(np.float32)]


# --- resample ----------------------------------------------------------------

@pytest.mark.parametrize("n_out,in_rate,out_rate", [
    (100_000, 44100, 22050), (100_000, 48000, 22050),
    (5000, 44100.0, 16000.0), (7, 22050, 44100), (50_000, 44100, 48000)])
def test_positions_equal(n_out, in_rate, out_rate):
    jb, jf = JR._positions(n_out, float(in_rate), float(out_rate))
    tb, tf = TR._positions(n_out, float(in_rate), float(out_rate))
    assert jb.dtype == tb.dtype and jf.dtype == tf.dtype
    assert np.array_equal(jb, tb) and np.array_equal(jf, tf)


@pytest.mark.parametrize("in_rate,channels", [
    (44100, 1), (44100, 2), (48000, 1)], ids=["44k_mono", "44k_stereo",
                                              "48k_mono"])
def test_resample_matches_reference(in_rate, channels):
    """3 s (more than one block of output rows), atol 1e-5."""
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((3 * in_rate, channels))).astype(
        np.float32)
    if channels == 1:
        x = x[:, 0]
    want = np.asarray(JR.resample(jnp.asarray(x), in_rate, ASR))
    got = TR.resample(_t(x), in_rate, ASR).numpy()
    assert got.shape == want.shape
    assert got.shape[0] > TR._BLOCK
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_kernel_taps_scaled_when_downsampling():
    assert TR.kernel_taps(44100, 22050) == 128
    assert TR.kernel_taps(48000, 22050) == 144
    assert TR.kernel_taps(22050, 44100) == 64


@pytest.fixture(scope="module")
def long_wav(tmp_path_factory):
    """35 s of 44.1 kHz stereo (noise over a 128 BPM click track)."""
    sr = 44100
    n = 35 * sr
    rng = np.random.default_rng(5)
    click = np.repeat(_click_track(128, seconds=35, sr=sr)[:, None], 2, 1)
    x = (0.1 * rng.standard_normal((n, 2)) + click).astype(np.float32)
    p = str(tmp_path_factory.mktemp("mus") / "long.wav")
    JW.write_wav(p, np.clip(x, -1, 1), sr)
    return p


def test_load_for_analysis_cut_equals_full_resample(long_wav):
    """The port resamples only the input samples that the 30 s window
    reads; its window equals ame_tpu's resample of the whole 35 s track cut
    to 30 s."""
    from ame_tpu.io import read_audio
    audio, sr = read_audio(long_wav)
    mono = np.mean(audio, axis=1).astype(np.float32)
    want = np.asarray(JR.resample(jnp.asarray(mono), sr, ASR))[:WINDOW]
    got = TM.load_for_analysis(long_wav, device="cpu").numpy()
    assert TR.input_needed(WINDOW, sr, ASR) < len(mono)
    assert got.shape == want.shape == (WINDOW,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- STFT / mel --------------------------------------------------------------

@pytest.mark.parametrize("n,fl,hop,center", [
    (22050, 2048, 512, True), (2048, 2048, 512, True),
    (2048 + 512 * 3, 2048, 512, False), (6000, 2000, 512, True),
    (4096, 1024, 256, False)])
def test_frame_signal_equal(n, fl, hop, center):
    y = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    want = np.asarray(JS.frame_signal(jnp.asarray(y), fl, hop, center))
    got = TS.frame_signal(_t(y), fl, hop, center).numpy()
    assert np.array_equal(got, want)


def test_stft_mel_db_match_reference():
    """rtol 1e-5. The magnitude's smallest bins (1e-3 of its peak on this
    noise) differ by up to 2.5e-5 relative, so its atol is 1e-5 of the
    peak; the mel power and the dB are held to rtol 1e-5 alone."""
    y = _noise(4 * ASR, seed=3)
    mag_j = np.asarray(JS.stft_mag(jnp.asarray(y), 2048, 512))
    np.testing.assert_allclose(TS.stft_mag(_t(y)).numpy(), mag_j,
                               rtol=1e-5, atol=1e-5 * mag_j.max())
    mel_j = np.asarray(JS.melspectrogram(jnp.asarray(y), float(ASR), 2048,
                                         128, 512))
    mel_t = TS.melspectrogram(_t(y), float(ASR)).numpy()
    np.testing.assert_allclose(mel_t, mel_j, rtol=1e-5)
    np.testing.assert_allclose(
        TS.power_to_db(_t(mel_t)).numpy(),
        np.asarray(JS.power_to_db(jnp.asarray(mel_j))), rtol=1e-5)
    assert np.array_equal(TS.mel_filterbank(ASR, 2048, 128),
                          JS.mel_filterbank(ASR, 2048, 128))


def test_power_to_db_reference_max_is_per_track():
    """A batch [B, mels, frames] takes each track's own max, so a track's
    dB does not depend on the others in its batch."""
    rng = np.random.default_rng(0)
    S = _t(rng.random((3, 16, 20)).astype(np.float32) * np.array(
        [1.0, 100.0, 1e-3], np.float32)[:, None, None])
    batched = TS.power_to_db(S)
    for b in range(3):
        assert torch.equal(batched[b], TS.power_to_db(S[b]))


# --- features ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["noise", "click128", "chord0",
                                  "chord1"])
def test_extract_all_matches_reference(name):
    """Tempo and key equal; centroid and RMS within rtol 1e-5."""
    y = {"noise": lambda: _noise(WINDOW),
         "click128": lambda: _click_track(128),
         "chord0": lambda: _key_chords()[0],
         "chord1": lambda: _key_chords()[1]}[name]()
    jt, jc, jr, jk = (float(v) for v in JF.extract_all(jnp.asarray(y),
                                                        float(ASR)))
    tt, tc, tr, tk = (float(v) for v in TF.extract_all(_t(y), float(ASR)))
    assert tt == jt and tk == jk, (name, tt, jt, tk, jk)
    np.testing.assert_allclose([tc, tr], [jc, jr], rtol=1e-5)
    if name == "click128":
        assert min(abs(tt - c) for c in (64, 128, 256)) < 3.0, tt
    if name.startswith("chord"):
        assert TF.key_name(tk) == ("C major", "A minor")[int(name[-1])]


def test_single_feature_functions_match_reference():
    y = _click_track(90, seconds=10)
    assert float(TF.tempo_bpm(_t(y), float(ASR))) == float(
        JF.tempo_bpm(jnp.asarray(y), float(ASR)))
    env_j = np.asarray(JF.onset_envelope(jnp.asarray(y), float(ASR)))
    np.testing.assert_allclose(TF.onset_envelope(_t(y), float(ASR)).numpy(),
                               env_j, rtol=1e-5, atol=1e-5 * env_j.max())
    np.testing.assert_allclose(
        [float(TF.spectral_centroid_mean(_t(y), float(ASR))),
         float(TF.rms_mean(_t(y)))],
        [float(JF.spectral_centroid_mean(jnp.asarray(y), float(ASR))),
         float(JF.rms_mean(jnp.asarray(y)))], rtol=1e-5)
    mag = TS.stft_mag(_t(_key_chords()[0]))
    assert TF.key_name(TF.key_index(mag, float(ASR))) == "C major"


def test_bucket_thresholds_exact():
    """The reference's exact thresholds (ai_tagger.py:87-89), in both
    packages."""
    for args in [(121, 0, 0), (120, 0, 0), (90, 0, 0), (0, 2001, 0),
                 (0, 2000, 0), (0, 1000, 0), (0, 0, 0.11), (0, 0, 0.1),
                 (0, 0, 0.09), (0, 0, 0.05), (0, 0, 0.04)]:
        assert TF.classify(*args) == JF.classify(*args)
    assert TF.classify(121, 2001, 0.11) == {
        "tempo_class": "fast", "brightness": "bright", "density": "dense"}
    assert TF.classify(90, 1000, 0.05) == {
        "tempo_class": "slow", "brightness": "dark", "density": "sparse"}


# --- spectrogram image -------------------------------------------------------

@pytest.mark.parametrize("seconds", [30.0, 2.0], ids=["30s", "2s"])
def test_spectrogram_image_matches_reference(seconds):
    """At 30 s (1292 frames -> 128 columns) the resize downsamples and must
    antialias as jax.image.resize does; at 2 s it upsamples. atol 1e-5."""
    y = _noise(int(seconds * ASR))
    want = np.asarray(JM.spectrogram_image(jnp.asarray(y)))
    got = TM.spectrogram_image(_t(y)).numpy()
    assert got.shape == want.shape == (128, 128, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_spectrogram_image_needs_the_antialias():
    """Without the antialias the 30 s image is far off the reference's: the
    check above could not pass by accident."""
    import torch.nn.functional as Fn
    y = _noise(WINDOW)
    want = np.asarray(JM.spectrogram_image(jnp.asarray(y)))
    db = TS.power_to_db(TS.melspectrogram(_t(y), float(ASR)))
    norm = (db - db.min()) / (db.max() - db.min())
    plain = Fn.interpolate(norm[None, None], size=(128, 128),
                           mode="bilinear", align_corners=False)[0, 0]
    assert np.abs(plain.numpy() - want[..., 0]).max() > 0.1


# --- the brief ---------------------------------------------------------------

def _mono_wav(tmp_path, name, y, sr=ASR):
    p = str(tmp_path / name)
    JW.write_wav(p, y[:, None], sr)
    return p


def test_analyze_song_matches_reference(long_wav, tmp_path):
    """Briefs equal on a 35 s 44.1 kHz stereo WAV and a 22.05 kHz mono
    one."""
    mono = _mono_wav(tmp_path, "mono.wav", 0.5 * _click_track(128, 12)
                     + _noise(12 * ASR, seed=4, scale=0.05))
    for p in (long_wav, mono):
        want = JM.analyze_song(p)
        got = TM.analyze_song(p, device="cpu")
        assert "error" not in want
        assert got == want, (p, got, want)


def test_analyze_song_error_contract(tmp_path):
    """Errors come back as {"error": str}, never raised: a missing file and
    a file the decoder rejects (a damaged MP3)."""
    brief = TM.analyze_song(str(tmp_path / "missing.wav"), device="cpu")
    assert set(brief) == {"error"} and brief["error"]
    p = tmp_path / "x.mp3"
    p.write_bytes(b"ID3\x04not really an mp3")
    brief = TM.analyze_song(str(p), device="cpu")
    assert set(brief) == {"error"} and "MP3 decode" in brief["error"]


def test_analyze_song_without_card_raises(tmp_path):
    """device="cuda" (the default) without a card is the caller's error and
    raises; it does not run on the host instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.analyze_song(str(tmp_path / "missing.wav"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.analyze_batch([str(tmp_path / "missing.wav")])


def test_analyze_batch_groups_and_matches_per_track(tmp_path, monkeypatch):
    """Mixed rates and lengths and a missing file: one batched pass per
    conditioned-length group, briefs equal to analyze_song's and to
    ame_tpu's analyze_batch."""
    rng = np.random.default_rng(11)
    paths = []
    for i, (secs, sr) in enumerate([(3.0, ASR), (2.0, 44100), (3.0, ASR),
                                    (2.0, 44100), (4.0, 48000)]):
        n = int(secs * sr)
        t = np.arange(n) / sr
        y = (0.3 * np.sin(2 * np.pi * (150 + 400 * i) * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        p = str(tmp_path / f"t{i}.wav")
        JW.write_wav(p, np.stack([y, 0.8 * y], 1), sr)
        paths.append(p)
    paths.insert(2, str(tmp_path / "missing.wav"))

    calls = []
    orig = TM._analyze_batch

    def counting(model, ys):
        calls.append(tuple(ys.shape))
        return orig(model, ys)

    monkeypatch.setattr(TM, "_analyze_batch", counting)
    briefs = TM.analyze_batch(paths, device="cpu")
    monkeypatch.setattr(TM, "_analyze_batch", orig)
    assert sorted(calls) == [(1, 88200), (2, 44100), (2, 66150)]
    assert len(briefs) == len(paths)
    assert set(briefs[2]) == {"error"}
    ref = JM.analyze_batch(paths)
    for p, brief, want in zip(paths, briefs, ref):
        if "error" in brief:
            continue
        assert brief == TM.analyze_song(p, device="cpu")
        assert brief == want
