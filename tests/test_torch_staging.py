"""The port's host staging (``ame_tpu_torch/io/staging.py``) on the CPU,
with a plain CPU allocator standing in for page-locking: the PCM16
decode given the pool's destination (``read_audio(..., into=)``) reads
into the pool's block with the bits of a plain decode; other files and a
decode given no destination keep today's allocation; the pool grows to
powers of two, reuses its blocks and counts ``host_bytes`` only when it
makes one; and ``master_file`` writes the same bytes whether its copies
go through a pool or not, and calls the functions the benchmark wraps
through their modules, once each."""

import struct
import threading

import numpy as np
import pytest
import torch

import ame_tpu_torch.io
from ame_tpu_torch import api
from ame_tpu_torch.graph import chain
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.io import read_audio, staging, write_audio
from ame_tpu_torch.ops.quantize import float_to_int16
from ame_tpu_torch.utils import telemetry

SR = 44100
FRAMES = 1001
SETTINGS = {"bass_boost": 1.5, "lufs": None}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    monkeypatch.setattr(telemetry, "_recorder", None)


class CountingAlloc:
    """Plain CPU blocks, with the size of each one made."""

    def __init__(self):
        self.sizes = []

    def __call__(self, nbytes):
        self.sizes.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)


def _pool():
    alloc = CountingAlloc()
    return staging.Pool(alloc), alloc


CPU = torch.device("cpu")


def _destination(pool, monkeypatch):
    """The decode destination ``staging`` gives for the CPU device, with
    ``pool`` injected as the CPU's."""
    monkeypatch.setattr(staging, "pool", lambda device: pool)
    return staging.decode_destination(CPU)


def _in_block(pool, a) -> bool:
    """Whether the pool uploads ``a`` from its block (on the CPU the upload
    is the block's own tensor)."""
    t = pool.upload(a, CPU)
    return t is not None and t.data_ptr() == a.ctypes.data


def _chunk(cid: bytes, body: bytes, size: int | None = None) -> bytes:
    size = len(body) if size is None else size
    return cid + struct.pack("<I", size) + body + b"\x00" * (len(body) & 1)


def _fmt(tag, channels, bits):
    block = channels * bits // 8
    return _chunk(b"fmt ", struct.pack("<HHIIHH", tag, channels, SR,
                                       SR * block, block, bits))


def _riff(*chunks: bytes) -> bytes:
    inner = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(inner)) + inner


def _pcm16(frames=FRAMES, channels=2, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, frames * channels).astype(
        "<i2").tobytes()


# the name a case is read under where it is not ``a.wav``: a PCM16 WAV
# under another extension is found by its RIFF magic
NAMES = {"riff_magic": "a.dat"}


def _pcm16_files():
    data = _pcm16()
    return {
        "plain": _riff(_fmt(1, 2, 16), _chunk(b"data", data)),
        "riff_magic": _riff(_fmt(1, 2, 16), _chunk(b"data", data)),
        "list_before_and_after": _riff(
            _chunk(b"LIST", b"\x01" * 26), _fmt(1, 2, 16),
            _chunk(b"data", data), _chunk(b"LIST", b"\x02" * 40)),
        "odd_chunk": _riff(_fmt(1, 2, 16), _chunk(b"junk", b"\x03" * 7),
                           _chunk(b"data", data)),
        # the data chunk declares more than the file holds
        "truncated": _riff(_fmt(1, 2, 16),
                           _chunk(b"data", data, size=len(data) + 4000))[:-4],
    }


@pytest.mark.parametrize("case", sorted(_pcm16_files()))
def test_staged_decode_reads_into_the_block(case, tmp_path, monkeypatch):
    path = tmp_path / NAMES.get(case, "a.wav")
    path.write_bytes(_pcm16_files()[case])
    want, want_sr = read_audio(str(path), prefer_int16=True)
    pool, alloc = _pool()
    into = _destination(pool, monkeypatch)
    got, sr = read_audio(str(path), prefer_int16=True, into=into)
    assert sr == want_sr and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    # the samples are the block's, from its start
    assert _in_block(pool, got)
    assert len(alloc.sizes) == 1


@pytest.mark.parametrize("tag,bits,prefer", [(1, 16, False), (1, 24, True),
                                             (1, 8, True), (3, 32, True)])
def test_other_files_in_the_scope_take_their_own_arrays(tag, bits, prefer,
                                                        tmp_path,
                                                        monkeypatch):
    """Only PCM16 read with ``prefer_int16`` is staged: every other read
    ignores the destination it is given."""
    n = FRAMES * 2 * bits // 8
    body = np.random.default_rng(1).integers(0, 256, n).astype(np.uint8)
    if tag == 3:
        body = np.random.default_rng(1).uniform(-1, 1, FRAMES * 2).astype(
            "<f4").view(np.uint8)
    path = tmp_path / "a.wav"
    path.write_bytes(_riff(_fmt(tag, 2, bits), _chunk(b"data",
                                                      body.tobytes())))
    want, _ = read_audio(str(path), prefer_int16=prefer)
    pool, alloc = _pool()
    got, _ = read_audio(str(path), prefer_int16=prefer,
                        into=_destination(pool, monkeypatch))
    np.testing.assert_array_equal(got, want)
    assert alloc.sizes == [] and pool.upload(got, CPU) is None


def test_a_decode_given_no_destination_takes_its_own_array(tmp_path,
                                                           monkeypatch):
    """The pool of this thread exists, and a destination was taken from
    it: a decode not given it allocates its own array, and no block."""
    path = tmp_path / "a.wav"
    path.write_bytes(_pcm16_files()["plain"])
    pool, alloc = _pool()
    _destination(pool, monkeypatch)
    got, _ = read_audio(str(path), prefer_int16=True)
    assert alloc.sizes == [] and pool.upload(got, CPU) is None
    np.testing.assert_array_equal(
        got, np.frombuffer(_pcm16(), "<i2").reshape(FRAMES, 2))


@pytest.mark.parametrize("case,error", [
    # a data chunk of no whole number of samples: raised before the read
    ("odd_data", ValueError),
    # no channels: raised after the samples landed in the block
    ("no_channels", ZeroDivisionError)])
def test_a_decode_that_raised_leaves_the_next_one_right(case, error, tmp_path,
                                                        monkeypatch):
    data = _pcm16()
    bad = tmp_path / "bad.wav"
    bad.write_bytes({
        "odd_data": _riff(_fmt(1, 2, 16), _chunk(b"data", data[:-1])),
        "no_channels": _riff(_fmt(1, 0, 16), _chunk(b"data", data[::-1])),
    }[case])
    path = tmp_path / "a.wav"
    path.write_bytes(_pcm16_files()["plain"])
    want, _ = read_audio(str(path), prefer_int16=True)
    pool, alloc = _pool()
    into = _destination(pool, monkeypatch)
    with pytest.raises(error):
        read_audio(str(bad), prefer_int16=True, into=into)
    got, _ = read_audio(str(path), prefer_int16=True, into=into)
    np.testing.assert_array_equal(got, want)
    assert _in_block(pool, got) and len(alloc.sizes) == 1


def test_the_pool_grows_to_powers_of_two_and_counts_only_growth():
    pool, alloc = _pool()
    steps = [("in", 1000, 1024), ("in", 1024, 0), ("in", 1025, 2048),
             ("in", 10, 0), ("out", 3, 4), ("out", 4, 0), ("in", 2048, 0),
             ("out", 1 << 20, 1 << 20), ("in", 1, 0)]
    with telemetry.tracing():
        for i, (direction, nbytes, _) in enumerate(steps):
            with telemetry.stage_timer(f"step{i}"):
                b = pool.block(direction, nbytes)
            assert b.numel() == nbytes and b.dtype == torch.uint8
    counted = {s.name: s.host_bytes for s in telemetry.records()}
    assert [counted[f"step{i}"] for i in range(len(steps))] == [
        grown for _, _, grown in steps]
    assert alloc.sizes == [1024, 2048, 4, 1 << 20]
    # a reused block is the same memory
    assert pool.block("in", 8).data_ptr() == pool.block("in", 2).data_ptr()


def test_pool_is_for_cuda_devices_only():
    assert staging.pool(torch.device("cpu")) is None
    p = staging.pool(torch.device("cuda"))     # makes no block yet
    assert p is staging.pool(torch.device("cuda"))
    seen = []
    t = threading.Thread(target=lambda: seen.append(
        staging.pool(torch.device("cuda"))))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen[0] is not p


def test_fetch_copies_into_the_out_block():
    pool, alloc = _pool()
    t = torch.arange(-6, 6, dtype=torch.int16).view(6, 2)
    a = pool.fetch(t)
    assert a.dtype == np.int16 and a.shape == (6, 2)
    np.testing.assert_array_equal(a, t.numpy())
    assert a.ctypes.data == pool.block("out", 1).data_ptr()
    assert alloc.sizes == [32]


# -- master_file --------------------------------------------------------------

def _track(tmp_path, name, frames, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((frames, 2)) * 3000).astype(np.int16)
    path = str(tmp_path / name)
    write_audio(path, pcm, SR)
    return path


def _parent_route(path, out, settings):
    """The file-to-file master as it was before the staging: a pageable
    upload of the decoded int16, the int16 quantize, ``.cpu()``."""
    from ame_tpu_torch.config import MasterSettings
    audio, sr = read_audio(path, prefer_int16=True)
    x = torch.from_numpy(audio).to(torch.float32) * (1.0 / 32768.0)
    y, _ = master_graph(x, sr, MasterSettings.from_dict(settings))
    write_audio(out, float_to_int16(y).to(torch.int16).cpu().numpy(), sr)
    with open(out, "rb") as f:
        return f.read()


def test_master_file_on_the_cpu_writes_the_same_bytes(tmp_path):
    path = _track(tmp_path, "a.wav", 1 << 14, 0)
    out = str(tmp_path / "out.wav")
    api.master_file(path, out, SETTINGS, device="cpu")
    with open(out, "rb") as f:
        assert f.read() == _parent_route(path, str(tmp_path / "p.wav"),
                                         SETTINGS)


def _spans_by_call():
    """{span name: host_bytes} of each ``api.master`` call, in order."""
    calls = {}
    for s in telemetry.records():
        calls.setdefault(s.track, {})[s.name] = s.host_bytes
    return [calls[k] for k in sorted(calls) if "api.master" in calls[k]]


def test_master_file_through_a_pool_keeps_its_bytes(tmp_path, monkeypatch):
    """The staged route on the CPU (a pool injected for the CPU device):
    the decode lands in the block, the upload reads it, the fetch fills
    the out block; the bytes are the parent route's, and ``host_bytes``
    counts a block only when one is made."""
    pool, alloc = _pool()
    monkeypatch.setattr(staging, "pool", lambda device: pool)
    seen = []
    real = pool.upload

    def upload(audio, device):
        out = real(audio, device)
        seen.append(out is not None)
        return out

    monkeypatch.setattr(pool, "upload", upload)
    short = _track(tmp_path, "a.wav", 5000, 0)
    long_ = _track(tmp_path, "b.wav", 9000, 1)
    with telemetry.tracing():
        for path in (short, short, long_, short):
            out = str(tmp_path / "out.wav")
            api.master_file(path, out, SETTINGS, device="cpu")
            with open(out, "rb") as f:
                assert f.read() == _parent_route(
                    path, str(tmp_path / "p.wav"), SETTINGS)
    assert seen == [True] * 4      # every call uploaded from the block
    assert alloc.sizes == [32768, 32768, 65536, 65536]
    counted = [(c["io.decode"], c["api.upload"], c["api.fetch"])
               for c in _spans_by_call()]
    assert counted == [(32768, 0, 32768), (0, 0, 0), (65536, 0, 65536),
                       (0, 0, 0)]


def test_master_array_and_float_outputs_bypass_the_blocks(tmp_path,
                                                          monkeypatch):
    """``master_array``'s own array uploads as it is; a 24-bit output
    fetches float, into no block."""
    pool, alloc = _pool()
    monkeypatch.setattr(staging, "pool", lambda device: pool)
    real = pool.upload
    monkeypatch.setattr(pool, "upload", lambda a, d: pytest.fail(
        "uploaded from a block") if real(a, d) is not None else None)
    audio, _ = read_audio(_track(tmp_path, "a.wav", 5000, 0), True)
    api.master_array(audio, SR, str(tmp_path / "o.wav"), SETTINGS,
                     device="cpu")
    assert alloc.sizes == [32768]                     # the out block only
    api.master_array(audio, SR, str(tmp_path / "o24.wav"),
                     dict(SETTINGS, bits=24), device="cpu")
    assert alloc.sizes == [32768]


@pytest.mark.parametrize("pooled", [False, True], ids=["pageable", "pool"])
def test_master_file_calls_the_wrapped_functions_once_each(pooled, tmp_path,
                                                           monkeypatch):
    """The benchmark's decode, write and chain spans wrap
    ``ame_tpu_torch.io.read_audio``, ``ame_tpu_torch.io.write_audio`` and
    ``ame_tpu_torch.graph.chain.master_graph`` by replacing those module
    attributes: ``master_file`` must look each up there, once a call."""
    if pooled:
        pool, _ = _pool()
        monkeypatch.setattr(staging, "pool", lambda device: pool)
    path = _track(tmp_path, "a.wav", 5000, 0)
    calls = []
    for mod, name in ((ame_tpu_torch.io, "read_audio"),
                      (ame_tpu_torch.io, "write_audio"),
                      (chain, "master_graph")):
        def counted(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    api.master_file(path, str(tmp_path / "out.wav"), SETTINGS, device="cpu")
    assert calls == ["read_audio", "master_graph", "write_audio"]
