"""Package-level properties of the port: no jax import, the precision
policy, the modes it runs, and the kernel build's failure mode."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ame_tpu_torch import precision
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """Importing every module of ame_tpu_torch (the Musicologist's, the
    fit's and the trainer's too) and loading the mood CNN's checkpoint
    leaves jax, flax, msgpack and ame_tpu unimported."""
    code = ("import importlib, pkgutil, sys\n"
            "import ame_tpu_torch\n"
            "for m in pkgutil.walk_packages(ame_tpu_torch.__path__, "
            "'ame_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import ame_tpu_torch.api\n"
            "import ame_tpu_torch.analysis.musicologist\n"
            "import ame_tpu_torch.creative.prompts\n"
            "import ame_tpu_torch.models.automaster\n"
            "import ame_tpu_torch.models.train_mood\n"
            "import ame_tpu_torch.models.checkpoint\n"
            "import ame_tpu_torch.models.synth_corpus\n"
            "import ame_tpu_torch.ops.sos_grad\n"
            "from ame_tpu_torch.models import mood_cnn\n"
            "assert mood_cnn.load_params(device='cpu')[1]\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "for name in ('flax', 'msgpack', 'ame_tpu'):\n"
            "    assert name not in sys.modules, name\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_streaming_imports_no_jax():
    """The streaming module, and the streamers through the package's lazy
    export, pull in neither jax nor ame_tpu."""
    code = ("import sys\n"
            "import ame_tpu_torch\n"
            "assert 'ame_tpu_torch.streaming' not in sys.modules\n"
            "cls = ame_tpu_torch.StreamingMaster\n"
            "from ame_tpu_torch.streaming import StreamingMaster, "
            "StreamingCompatMaster\n"
            "assert cls is StreamingMaster\n"
            "assert ame_tpu_torch.StreamingCompatMaster is "
            "StreamingCompatMaster\n"
            "for name in ('jax', 'ame_tpu'):\n"
            "    assert name not in sys.modules, name\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("name", ["StreamingMaster", "StreamingCompatMaster"])
def test_streamers_raise_without_card(name, monkeypatch):
    """A streamer asked for the card (the default) on a machine without one
    raises; it never falls back to the CPU."""
    import ame_tpu_torch
    cls = getattr(ame_tpu_torch, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(44100, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(44100, {}, device="cuda")
    assert cls(44100, {}, device="cpu").latency_samples > 0
    with pytest.raises(AttributeError):
        ame_tpu_torch.NotAStreamer


def test_precision_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert precision.tf32_enabled()
        precision.apply()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert not precision.tf32_enabled()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_master_graph_applies_precision_policy():
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        master_graph(torch.zeros(4096, 2), 44100, MasterSettings())
        assert not precision.tf32_enabled()
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("settings", [
    dict(mode="compat", compat_chunked=True),
    dict(multiband=True),
    dict(mb_edges=(250.0, 2000.0)),
], ids=["compat", "multiband", "g_band"])
def test_unported_modes_raise(settings):
    """The three modes that raised NotImplementedError until they were
    ported (chunked compat, quality multiband, G-band edges) now run on
    the CPU and give a finite [N, 2] master; master_graph refuses none."""
    x = 0.1 * torch.from_numpy(
        np.random.default_rng(0).standard_normal((4096, 2)).astype(
            np.float32))
    y, _ = master_graph(x, 44100, MasterSettings(**settings))
    assert y.shape == (4096, 2) and torch.isfinite(y).all()
    assert y.abs().max() > 0.0


def test_unported_formats_raise(tmp_path):
    """Formats are no longer refused wholesale: a damaged MP3 fails in its
    decoder, and only a format no codec writes is refused."""
    from ame_tpu_torch.io import read_audio, write_audio
    p = tmp_path / "x.mp3"
    p.write_bytes(b"ID3\x04not really an mp3")
    with pytest.raises(RuntimeError, match="MP3 decode"):
        read_audio(str(p))
    with pytest.raises(ValueError, match="unsupported output format"):
        write_audio(str(tmp_path / "y.xyz"), torch.zeros(8, 2).numpy(),
                    44100)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no CUDA toolkit the build fails with a clear error, before
    anything is written."""
    from ame_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_OUT", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("cascade_scan")
    assert not (tmp_path / "out").exists()
