"""The port's command line (ame_tpu_torch.cli, python -m ame_tpu_torch) on
the CPU (--device cpu), against ame_tpu.cli on the same WAVs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ame_tpu_torch.cli import main
from ame_tpu_torch.io import codecs
from ame_tpu_torch.io.wav import read_wav, write_wav
from tests.conftest import make_test_signal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
FLAGSHIP_ARGS = ["--analog-character", "20", "--bass", "2", "--presence",
                 "1.5", "--width", "1.2"]


@pytest.fixture
def track(tmp_path):
    p = str(tmp_path / "in.wav")
    write_wav(p, make_test_signal("noise", 4096, SR) * 0.2, SR)
    return p


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def test_cli_master_matches_reference(tmp_path, capsys):
    """master --mp3 on the CPU: the info JSON, the WAV within +-1 LSB of
    ame_tpu's CLI on the same 2^16-sample WAV, and the MP3 sidecar (where
    LAME is present) decoding to the master's length."""
    from ame_tpu.cli import main as ref_main
    src = str(tmp_path / "in.wav")
    write_wav(src, make_test_signal("noise", 1 << 16, SR) * 0.3, SR)
    out, ref_out = str(tmp_path / "out.wav"), str(tmp_path / "ref.wav")
    assert ref_main(["master", src, ref_out, *FLAGSHIP_ARGS]) == 0
    capsys.readouterr()
    assert main(["master", src, out, *FLAGSHIP_ARGS, "--mp3",
                 "--device", "cpu"]) == 0
    info = _last_json(capsys)
    assert info["output_file"] == out and info["n_samples"] == 1 << 16
    assert abs(info["output_i"] + 14.0) < 0.5
    y, _ = read_wav(out, prefer_int16=True)
    y_ref, _ = read_wav(ref_out, prefer_int16=True)
    assert np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max() <= 1
    mp3 = str(tmp_path / "out.mp3")
    if codecs.have_mp3_encode():
        assert os.path.getsize(mp3) > 1000
        if codecs.have_mp3_decode():
            assert abs(len(codecs.decode_mp3(mp3)[0]) - (1 << 16)) < 5000
    else:
        assert not os.path.exists(mp3)


@pytest.mark.parametrize("args", [
    ["--preset", "Bass Punch", "--no-lufs"],
    ["--mb-edges", "150,1000,6000", "--mb-ratios", "3,3,3,3", "--no-lufs"],
    ["--mode", "compat", "--multiband", "--no-lufs"],
], ids=["preset", "mb_edges", "compat"])
def test_cli_master_options(track, tmp_path, capsys, args):
    """--preset, --mb-edges and compat multiband each master a finite WAV;
    the preset's EQ differs from a flat master."""
    out = str(tmp_path / "p.wav")
    assert main(["master", track, out, *args, "--device", "cpu"]) == 0
    assert _last_json(capsys)["output_file"] == out
    y, sr = read_wav(out)
    assert sr == SR and y.shape == (4096, 2) and np.isfinite(y).all()
    if args[0] == "--preset":
        flat = str(tmp_path / "flat.wav")
        main(["master", track, flat, "--no-lufs", "--device", "cpu"])
        assert np.abs(read_wav(flat)[0] - y).max() > 1e-3


def test_settings_from_args_matches_reference(track, tmp_path):
    """_settings_from_args builds ame_tpu's settings dict from the same
    command line (presets, --mb-edges implying multiband, --no-lufs)."""
    from ame_tpu import cli as ref_cli
    from ame_tpu_torch import cli
    argv = ["master", track, "o.wav", "--preset", "Lo-Fi Haze",
            "--mb-edges", "200,2000", "--no-lufs", "--bits", "24", "--mp3"]
    ref_parser = ref_cli.argparse.ArgumentParser()
    sub = ref_parser.add_subparsers(dest="cmd")
    ref_cli._add_master_args(sub.add_parser("master"))
    want = ref_cli._settings_from_args(ref_parser.parse_args(argv))
    got = cli._settings_from_args(cli._parser().parse_args(argv))
    assert got == want


def test_cli_analyze_single_and_batched(track, tmp_path, capsys):
    """One path prints analyze_song's brief; several print one brief a
    path (analyze_batch)."""
    assert main(["analyze", track, "--device", "cpu"]) == 0
    brief = _last_json(capsys)
    assert {"mood", "tempo", "brightness", "density", "key"} <= set(brief)
    p2 = str(tmp_path / "in2.wav")
    write_wav(p2, make_test_signal("tone", 4096, SR) * 0.3, SR)
    assert main(["analyze", track, p2, "--device", "cpu"]) == 0
    briefs = _last_json(capsys)
    assert set(briefs) == {track, p2}
    assert briefs[track] == brief


@pytest.mark.parametrize("extra", [[], ["--input-only"]],
                         ids=["pass1", "input_only"])
def test_cli_measure_matches_reference(tmp_path, capsys, extra):
    """measure's JSON: the same keys as ame_tpu's CLI and every value
    within 0.01 on a 3 s 997 Hz sine."""
    from ame_tpu.cli import main as ref_main
    t = np.arange(SR * 3) / SR
    tone = (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    p = str(tmp_path / "tone.wav")
    write_wav(p, np.stack([tone, tone], axis=1), SR)
    assert ref_main(["measure", p, *extra]) == 0
    want = _last_json(capsys)
    assert main(["measure", p, *extra, "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            assert abs(got[k] - v) <= 0.01 + 1e-9, (k, got[k], v)


def test_cli_automaster(tmp_path, capsys):
    """automaster with 3 steps toward a bass-boosted reference at another
    rate (resampled): a finite loss, the fitted settings, and the master
    written with them."""
    from ame_tpu_torch.ops.eq import apply_eq_quality
    import torch
    x = make_test_signal("noise", SR, SR) * 0.2
    t = apply_eq_quality(torch.from_numpy(x), SR, 4.0, 0.0, 0.0, 0.0).numpy()
    src, ref, out = (str(tmp_path / n) for n in ("s.wav", "r.wav", "o.wav"))
    write_wav(src, x, SR)
    write_wav(ref, np.clip(t[::2], -1, 1), SR // 2)
    assert main(["automaster", src, ref, out, "--steps", "3", "--lr", "0.1",
                 "--no-lufs", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()
             if ln.startswith("{")]
    fitted, info = lines
    assert np.isfinite(fitted["loss"]) and "bass_boost" in fitted
    assert info["output_file"] == out and os.path.exists(out)


def test_module_help_in_subprocess():
    r = subprocess.run([sys.executable, "-m", "ame_tpu_torch", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for cmd in ("master", "analyze", "measure", "automaster", "serve",
                "gui", "profile", "fleet"):
        assert cmd in r.stdout
    r = subprocess.run([sys.executable, "-m", "ame_tpu_torch", "master",
                        "--help"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "--device {cuda,cpu}" in r.stdout


def test_cli_gui_runs_the_port_gui_on_the_device(monkeypatch):
    """gui: no display here, so run_gui is recorded, not run; the command
    imports the port's Tk view and hands it --device."""
    from ame_tpu_torch import gui
    seen = []
    monkeypatch.setattr(gui, "run_gui", lambda device: seen.append(device))
    assert main(["gui", "--device", "cpu"]) == 0
    assert main(["gui"]) == 0
    assert seen == ["cpu", "cuda"]


def test_cli_profile_on_the_cpu(track, capsys):
    """profile --device cpu prints ame_tpu's report keys with its stage
    names."""
    assert main(["profile", track, "--runs", "2", "--bass", "1.5",
                 "--device", "cpu"]) == 0
    rep = _last_json(capsys)
    assert {"n_samples", "cold_start_s", "steady_ms", "x_realtime",
            "stages_ms", "host_rss_mb"} <= set(rep)
    assert set(rep["stages_ms"]) == {"analog_eq_width", "loudnorm",
                                     "limiter"}


def test_cli_fleet_on_the_cpu_exits_2_on_a_failed_track(tmp_path, capsys):
    """fleet --device cpu: exit 0 with the summary JSON when every track
    masters; after a corrupt file joins, exit 2 and the summary counts it
    (the finished track is skipped on resume)."""
    src, dst = tmp_path / "in", str(tmp_path / "out")
    src.mkdir()
    write_wav(str(src / "a.wav"), make_test_signal("noise", 4096, SR) * 0.2,
              SR)
    argv = ["fleet", str(src), dst, "--no-lufs", "--bass", "1",
            "--device", "cpu"]
    assert main(argv) == 0
    summary = _last_json(capsys)
    assert summary["done"] == 1 and summary["failed"] == 0
    assert os.path.exists(os.path.join(dst, "a_mastered.wav"))
    (src / "b.wav").write_bytes(b"RIFFbroken")
    assert main(argv) == 2
    summary = _last_json(capsys)
    assert summary == {"total": 2, "done": 0, "resumed_skips": 1,
                       "failed": 1, "manifest": summary["manifest"]}
    with open(summary["manifest"]) as f:
        assert json.load(f)["b.wav"]["status"] == "error"


@pytest.mark.parametrize("cmd", ["profile", "fleet"])
def test_cli_profile_and_fleet_default_to_the_card(cmd, track, tmp_path):
    """Without --device the commands run on the card, and raise where
    there is none (never a silent CPU run)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = {"profile": ["profile", track, "--runs", "1"],
            "fleet": ["fleet", os.path.dirname(track),
                      str(tmp_path / "out")]}[cmd]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
