"""The page-locked staging of ``api.master_file`` on the card (the ``cuda``
marker): the masters are bit for bit those of the pageable route it
replaced, at the benchmark cells' settings; the blocks are page-locked;
``io.decode``, ``api.upload`` and ``api.fetch`` count no host bytes from
the second call of a size class on; two threads master at once; and a
call that raised after its upload leaves the next call's master right.
Without a card each test skips.

Imports no JAX: on the card run ``python -m pytest -m cuda --noconftest
-p no:cacheprovider tests/test_torch_staging_card.py``."""

import threading

import numpy as np
import pytest
import torch

from ame_tpu_torch import api
from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph import chain
from ame_tpu_torch.io import read_audio, staging, write_audio
from ame_tpu_torch.ops.quantize import float_to_int16
from ame_tpu_torch.utils import telemetry

SR = 44100
# the benchmark cells' settings (cudabench/configs/quality_flagship*.json)
NOLUFS = {"mode": "quality", "analog_character": 20.0, "bass_boost": 2.0,
          "presence_boost": 1.5, "width": 1.2, "lufs": None}
LUFS = dict(NOLUFS, lufs=-14.0, target_tp=-1.5, target_lra=11.0)


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the blocks are page-locked for "
                    "its copies")
    monkeypatch.setattr(telemetry, "_recorder", None)
    return torch.device("cuda")


def _track(tmp_path, name, seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    pcm = (rng.standard_normal((n, 2)) * 3000).astype(np.int16)
    pcm[n // 3: n // 2] = 0                     # digital silence
    path = str(tmp_path / name)
    write_audio(path, pcm, SR)
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _pageable_route(path, out, settings):
    """The master as it was before the staging: the decoded int16 uploaded
    from pageable memory, the int16 fetched into a fresh ``.cpu()``."""
    audio, sr = read_audio(path, prefer_int16=True)
    x = torch.from_numpy(audio).to("cuda").to(torch.float32) * (1.0 / 32768.0)
    y, _ = chain.master_graph(x, sr, MasterSettings.from_dict(settings))
    write_audio(out, float_to_int16(y).to(torch.int16).cpu().numpy(), sr)
    return _read(out)


@pytest.mark.cuda
@pytest.mark.parametrize("settings", [NOLUFS, LUFS], ids=["nolufs", "lufs"])
def test_masters_are_the_pageable_routes_bits(card, settings, tmp_path):
    for seconds, seed in ((20.0, 0), (7.3, 1), (20.0, 2)):
        path = _track(tmp_path, f"in{seed}.wav", seconds, seed)
        out = str(tmp_path / "out.wav")
        api.master_file(path, out, settings, device=card)
        assert _read(out) == _pageable_route(path, str(tmp_path / "p.wav"),
                                             settings)
    pool = staging.pool(card)
    assert pool.block("in", 16).is_pinned()
    assert pool.block("out", 16).is_pinned()


def _spans_by_call():
    calls = {}
    for s in telemetry.records():
        calls.setdefault(s.track, {})[s.name] = s.host_bytes
    return [calls[k] for k in sorted(calls) if "api.master" in calls[k]]


@pytest.mark.cuda
def test_no_host_bytes_from_the_second_call_of_a_size_class(card, tmp_path):
    """On a thread of its own (a fresh pool): the first call makes the two
    blocks, counted in ``io.decode`` and ``api.fetch``; the next calls of
    the class count nothing."""
    short = _track(tmp_path, "a.wav", 10.0, 0)      # 1 764 000 B: 2 MiB
    other = _track(tmp_path, "b.wav", 9.0, 1)       # the same class
    counted, errors = [], []

    def run():
        try:
            with telemetry.tracing():
                for path in (short, short, other):
                    api.master_file(path, str(tmp_path / "o.wav"), NOLUFS,
                                    device=card)
            counted.extend((c["io.decode"], c["api.upload"], c["api.fetch"])
                           for c in _spans_by_call())
        except Exception as e:       # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    assert counted == [(1 << 21, 0, 1 << 21), (0, 0, 0), (0, 0, 0)]


@pytest.mark.cuda
def test_two_threads_master_at_once(card, tmp_path):
    paths = [_track(tmp_path, "a.wav", 15.0, 3), _track(tmp_path, "b.wav",
                                                        11.0, 4)]
    want = [_pageable_route(p, str(tmp_path / f"p{i}.wav"), NOLUFS)
            for i, p in enumerate(paths)]
    start = threading.Barrier(2)
    got, errors = [[], []], []

    def run(i):
        try:
            start.wait(timeout=60)
            for k in range(3):
                out = str(tmp_path / f"o{i}_{k}.wav")
                api.master_file(paths[i], out, NOLUFS, device=card)
                got[i].append(_read(out))
        except Exception as e:       # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == [[want[0]] * 3, [want[1]] * 3]


@pytest.mark.cuda
def test_a_call_that_raised_after_its_upload_leaves_the_next_right(
        card, tmp_path, monkeypatch):
    first = _track(tmp_path, "a.wav", 20.0, 5)
    second = _track(tmp_path, "b.wav", 19.0, 6)
    want = _pageable_route(second, str(tmp_path / "p.wav"), LUFS)

    def fail(x, sr, settings, **kw):
        # device work queued behind the upload, then the raise: the upload
        # may still be running when the next decode wants the block
        for _ in range(20):
            x = x * 1.0
        raise RuntimeError("chain failed")

    monkeypatch.setattr(chain, "master_graph", fail)
    with pytest.raises(RuntimeError, match="chain failed"):
        api.master_file(first, str(tmp_path / "o.wav"), LUFS, device=card)
    monkeypatch.undo()
    api.master_file(second, str(tmp_path / "o.wav"), LUFS, device=card)
    assert _read(str(tmp_path / "o.wav")) == want
