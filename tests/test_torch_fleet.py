"""The port's fleet runner (ame_tpu_torch.parallel.fleet) on the CPU: the
manifest's checkpoint / resume semantics, errors recorded while the run
goes on (tests/test_fleet.py's contract), and every master held to
ame_tpu.graph.chain.master_graph on the decoded track."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch.io import loader, read_audio
from ame_tpu_torch.io.wav import read_wav, write_wav
from ame_tpu_torch.parallel import fleet
from ame_tpu_torch.parallel.fleet import Manifest, run_fleet
from tests.conftest import make_test_signal

SR = 44100
N = 1 << 16
QUALITY = {"bass_boost": 1.0, "analog_character": 20.0, "width": 1.2,
           "lufs": -14.0, "create_mp3": False}
COMPAT = dict(QUALITY, mode="compat", multiband=True)
LSB = 1.0 / 32768.0


def _make_tracks(d, names, n=N):
    os.makedirs(d, exist_ok=True)
    for i, name in enumerate(names):
        x = make_test_signal("noise", n, SR, seed=i) * 0.6
        write_wav(os.path.join(d, name), x, SR)


def _ref_master(path, settings):
    """ame_tpu's master_graph on the decoded track (float32 [N, 2])."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.graph.chain import master_graph as ref_master_graph
    audio, _ = read_audio(path)
    keep = {k: v for k, v in settings.items() if k != "create_mp3"}
    y, _ = ref_master_graph(jnp.asarray(audio), float(SR),
                            RefSettings(**keep))
    return np.asarray(y)


def test_fleet_and_resume(tmp_path):
    """Three tracks master; each output is ame_tpu's master_graph on the
    decoded track within 2e-4 (PERF.md section 2) plus the output's int16
    rounding; a second run skips them all; a new track alone runs next."""
    src, dst = str(tmp_path / "in"), str(tmp_path / "out")
    _make_tracks(src, ["a.wav", "b.wav", "c.wav"])
    s1 = run_fleet(src, dst, QUALITY, device="cpu")
    assert s1["done"] == 3 and s1["failed"] == 0 and s1["total"] == 3
    manifest = json.load(open(s1["manifest"]))
    assert set(manifest) == {"a.wav", "b.wav", "c.wav"}
    assert all(m["status"] == "done" for m in manifest.values())
    for name in ("a", "b", "c"):
        out = os.path.join(dst, f"{name}_mastered.wav")
        assert manifest[f"{name}.wav"]["output"] == out
        y, sr = read_wav(out)
        assert sr == SR and y.shape == (N, 2)
        want = _ref_master(os.path.join(src, f"{name}.wav"), QUALITY)
        assert np.abs(y - want).max() <= 2e-4 + LSB
        assert abs(manifest[f"{name}.wav"]["output_i"] + 14.0) < 0.5

    s2 = run_fleet(src, dst, QUALITY, device="cpu")
    assert s2["done"] == 0 and s2["resumed_skips"] == 3

    _make_tracks(src, ["d.wav"])
    s3 = run_fleet(src, dst, QUALITY, device="cpu")
    assert s3["done"] == 1 and s3["resumed_skips"] == 3


def test_fleet_records_errors_and_continues(tmp_path):
    """A file that does not decode is marked error with its message, the
    good one masters, and the failed one is retried on the next run."""
    src, dst = str(tmp_path / "in"), str(tmp_path / "out")
    _make_tracks(src, ["good.wav"], n=4096)
    with open(os.path.join(src, "bad.wav"), "wb") as f:
        f.write(b"not audio at all")
    with open(os.path.join(src, "notes.txt"), "w") as f:
        f.write("not a track")
    statuses = []
    settings = {"lufs": None, "create_mp3": False}
    s = run_fleet(src, dst, settings, status_callback=statuses.append,
                  device="cpu")
    assert s["failed"] == 1 and s["done"] == 1 and s["total"] == 2
    manifest = json.load(open(s["manifest"]))
    assert manifest["bad.wav"]["status"] == "error"
    assert manifest["bad.wav"]["error"]
    assert manifest["good.wav"]["status"] == "done"
    assert statuses[:2] == ["Mastering bad.wav...", "Mastering good.wav..."]
    assert statuses[-1].startswith("Fleet complete: ")
    s2 = run_fleet(src, dst, settings, device="cpu")
    assert s2["failed"] == 1 and s2["resumed_skips"] == 1


def test_fleet_compat_track_and_loader_routes(tmp_path, monkeypatch):
    """A fleet of a WAV in quality mode, then an AIFF in compat multiband
    mode from a second directory into the same output and manifest: the
    WAV decodes natively, the AIFF through the Python route; the quality
    master holds to ame_tpu's master_graph within 2e-4 plus its rounding,
    the compat one to ame_tpu's compat chain (relative L2 < 3e-3 or max
    abs <= 2 LSB, tests/test_chain.py:73-75's gate, on the int16
    output)."""
    from ame_tpu_torch.io.wav import write_aiff
    monkeypatch.setattr(loader, "decodes", {"native": {}, "python": {}})
    src, dst = str(tmp_path / "in"), str(tmp_path / "out")
    compat_src = str(tmp_path / "in_compat")
    manifest = str(tmp_path / "m.json")
    _make_tracks(src, ["w.wav"])
    os.makedirs(compat_src)
    x = make_test_signal("noise", N, SR, seed=5) * 0.6
    write_aiff(os.path.join(compat_src, "x.aiff"), x, SR, 16)
    s = run_fleet(src, dst, QUALITY, manifest_path=manifest, device="cpu")
    assert s["done"] == 1 and s["manifest"] == manifest
    s = run_fleet(compat_src, dst, COMPAT, manifest_path=manifest,
                  device="cpu")
    assert s["done"] == 1 and s["manifest"] == manifest
    assert {k: v["status"] for k, v in json.load(open(manifest)).items()} \
        == {"w.wav": "done", "x.aiff": "done"}
    assert loader.decodes == {"native": {".wav": 1},
                              "python": {".aiff": 1}}
    y, _ = read_wav(os.path.join(dst, "w_mastered.wav"))
    want = _ref_master(os.path.join(src, "w.wav"), QUALITY)
    assert np.abs(y - want).max() <= 2e-4 + LSB
    y, _ = read_wav(os.path.join(dst, "x_mastered.wav"))
    want = _ref_master(os.path.join(compat_src, "x.aiff"), COMPAT)
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 3e-3 or np.abs(y - want).max() <= 2 * LSB


def test_manifest_is_fsynced_and_renamed(tmp_path, monkeypatch):
    """Every mark writes a temp file, fsyncs it and renames it over the
    manifest; a new Manifest reads the state back."""
    synced, replaced = [], []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(fleet.os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd)))
    monkeypatch.setattr(fleet.os, "replace",
                        lambda a, b: (replaced.append((a, b)),
                                      real_replace(a, b)))
    path = str(tmp_path / "m.json")
    m = Manifest(path)
    assert m.status("x.wav") == "pending"
    m.mark("x.wav", "done", output="o.wav")
    m.mark("y.wav", "error", error="boom")
    assert len(synced) == 2
    assert replaced == [(path + ".tmp", path)] * 2
    assert not os.path.exists(path + ".tmp")
    again = Manifest(path)
    assert again.status("x.wav") == "done"
    assert again.state["y.wav"]["error"] == "boom"


def test_fleet_defaults_to_the_card(tmp_path):
    """device="cuda" is the default and raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = str(tmp_path / "in")
    _make_tracks(src, ["a.wav"], n=1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet(src, str(tmp_path / "out"), QUALITY)
