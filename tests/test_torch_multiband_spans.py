"""The quality multiband stage's spans and the release scan's launch
counter, on the CPU: under ``chain.multiband`` a traced master records
``multiband.split``, ``.level``, ``.release``, ``.attack`` and ``.apply``
in that order (3 bands and G bands), and nothing with tracing off;
``window.release_scan.launches`` counts the kernels a call enqueues (each
op that makes a non-empty tensor that is not a view of another), and a
quality master on the CPU counts both of its callers, the multiband
compressor and the plain limiter."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ame_tpu_torch import api
from ame_tpu_torch.io.wav import write_wav
from ame_tpu_torch.ops import window as W
from ame_tpu_torch.utils import telemetry

SR = 44100
RHO = float(np.exp(-1.0 / (50.0 * SR / 1000.0)))
MB = {"bass_boost": 1.5, "lufs": None, "multiband": True}
MB4 = dict(MB, mb_edges=[200.0, 1500.0, 6000.0])
CHILDREN = ["multiband.split", "multiband.level", "multiband.release",
            "multiband.attack", "multiband.apply"]


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """No recorder from an earlier test: records() starts empty."""
    monkeypatch.setattr(telemetry, "_recorder", None)


@pytest.fixture
def track(tmp_path):
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((int(1.5 * SR), 2))).astype(np.float32)
    path = tmp_path / "in.wav"
    write_wav(str(path), x, SR)
    return str(path)


@pytest.mark.parametrize("settings", [MB, MB4], ids=["3band", "4band"])
def test_multiband_children_nest_under_the_stage(settings, track, tmp_path):
    with telemetry.tracing():
        api.master_file(track, str(tmp_path / "out.wav"), settings,
                        device="cpu")
    spans = telemetry.records()
    (stage,) = [s for s in spans if s.name == "chain.multiband"]
    kids = sorted((s for s in spans if s.parent == stage.id),
                  key=lambda s: s.t0)
    assert [s.name for s in kids] == CHILDREN
    for s in kids:
        assert stage.t0 <= s.t0 <= s.t1 <= stage.t1
        assert s.track == stage.track and s.dev_t0 is None
    assert not [s for s in spans if s.name.startswith("multiband.")
                and s.parent != stage.id]


def test_multiband_spans_absent_with_tracing_off(track, tmp_path):
    api.master_file(track, str(tmp_path / "out.wav"), MB, device="cpu")
    assert telemetry.records() == []


class _Kernels(TorchDispatchMode):
    """Counts the ops that make a non-empty tensor which is not a view of
    an input: on a card, each is one kernel (or memset) launch."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        view = (func is torch.ops.aten._unsafe_view.default
                or any(r.alias_info is not None for r in rets))
        if (not view and isinstance(out, torch.Tensor)
                and out.numel() > 0):
            self.n += 1
        return out


def _counted(fn):
    before = W.release_scan.launches
    with _Kernels() as ops:
        out = fn()
    return out, W.release_scan.launches - before, ops.n


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 4096, 128 * 64 + 1,
                               300_000])
@pytest.mark.parametrize("cols", [None, 3])
def test_release_scan_counts_what_it_enqueues(n, cols):
    shape = (n,) if cols is None else (n, cols)
    u = torch.rand(shape, generator=torch.Generator().manual_seed(n))
    _, counted, ops = _counted(lambda: W.release_scan(u, RHO))
    assert counted == ops > 0


def test_release_scan_count_at_the_album_mean_track():
    """107 at the album mix's mean track (the docstring's figure): 7
    sweeps in a block of 128, 17 over the 75 797 blocks' ends."""
    _, counted, _ = _counted(lambda: W.release_scan(
        torch.zeros(9_702_000), RHO))
    assert counted == 107


@pytest.mark.parametrize("settings, cols", [(MB, 3), (MB4, 4),
                                            ({"lufs": None}, None)],
                         ids=["3band", "4band", "no_multiband"])
def test_quality_master_counts_both_callers(settings, cols, track,
                                            tmp_path):
    """A quality master on the CPU: the limiter's plain release scan over
    [N] and, with multiband on, the compressor's over [N, G]."""
    n = int(1.5 * SR)
    per = {}
    for c in {None, cols}:
        shape = (n,) if c is None else (n, c)
        _, per[c], _ = _counted(lambda: W.release_scan(torch.zeros(shape),
                                                       RHO))
    before = W.release_scan.launches
    api.master_file(track, str(tmp_path / "out.wav"), settings,
                    device="cpu")
    want = per[None] + (per[cols] if cols else 0)
    assert W.release_scan.launches - before == want
