"""The port's WAV / AIFF codec (``ame_tpu_torch/io/wav.py``) reads the
sample chunk straight into the array it returns and writes the array's own
memory. Held against ``ame_tpu.io.wav`` on the CPU: the same arrays (or
the same exception) from the same files, the same bytes from the same
arrays; the returned array is the caller's own, sized to its samples; and
the ``host_bytes`` counter of the ``io.decode`` / ``io.write`` spans."""

import os
import struct
import threading
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from ame_tpu.io import wav as ref
from ame_tpu_torch.io import read_audio, write_audio
from ame_tpu_torch.io import wav as port
from ame_tpu_torch.utils import telemetry

SR = 44100
FRAMES = 1001                      # odd, so 8- and 24-bit bodies are odd


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    monkeypatch.setattr(telemetry, "_recorder", None)


def _chunk(cid: bytes, body: bytes, size: int | None = None) -> bytes:
    size = len(body) if size is None else size
    return cid + struct.pack("<I", size) + body + b"\x00" * (len(body) & 1)


def _fmt(tag, channels, bits, extensible=False):
    block = channels * bits // 8
    body = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels,
                       SR, SR * block, block, bits)
    if extensible:
        body += struct.pack("<HHI", 22, bits, 0) + struct.pack(
            "<H", tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38"
        body += b"\x9b\x71"
    return _chunk(b"fmt ", body)


def _riff(*chunks: bytes, size: int | None = None) -> bytes:
    inner = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack(
        "<I", len(inner) if size is None else size) + inner


def _samples(tag, bits, channels, frames=FRAMES, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    n = frames * channels
    if tag == 3:
        x = rng.uniform(-1.2, 1.2, n)
        return x.astype("<f4" if bits == 32 else "<f8").tobytes()
    if bits == 8:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if bits == 24:
        return rng.integers(0, 256, n * 3, dtype=np.uint8).tobytes()
    dt = "<i2" if bits == 16 else "<i4"
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True)
    x[:4] = [info.min, info.max, 0, -1]
    return x.astype(dt).tobytes()


def _read_both(path, reader="read_wav", **kw):
    """The reference's result or exception type, and the port's."""
    out = []
    for mod in (ref, port):
        try:
            out.append(getattr(mod, reader)(str(path), **kw))
        except Exception as e:     # the type is what is compared
            out.append(type(e))
    return out


def _assert_same(path, reader="read_wav", **kw):
    want, got = _read_both(path, reader, **kw)
    if isinstance(want, type):
        assert got is want
        return None
    assert not isinstance(got, type), got
    (a, ra), (b, rb) = want, got
    assert ra == rb
    assert b.dtype == a.dtype and b.shape == a.shape
    np.testing.assert_array_equal(b, a)
    return b


# -- reads ------------------------------------------------------------------

FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32), (3, 64)]


@pytest.mark.parametrize("prefer_int16", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("tag,bits", FORMATS)
def test_read_formats(tmp_path, tag, bits, channels, prefer_int16):
    path = tmp_path / "a.wav"
    path.write_bytes(_riff(_fmt(tag, channels, bits),
                           _chunk(b"data", _samples(tag, bits, channels))))
    x = _assert_same(path, prefer_int16=prefer_int16)
    assert x.shape == (FRAMES, channels)


@pytest.mark.parametrize("tag,bits", [(1, 16), (1, 24), (3, 32)])
def test_read_extensible(tmp_path, tag, bits):
    path = tmp_path / "a.wav"
    path.write_bytes(_riff(_fmt(tag, 2, bits, extensible=True),
                           _chunk(b"data", _samples(tag, bits, 2))))
    for prefer in (False, True):
        _assert_same(path, prefer_int16=prefer)


def _layout(name):
    fmt16 = _fmt(1, 2, 16)
    data = _chunk(b"data", _samples(1, 16, 2))
    other = _chunk(b"data", _samples(1, 16, 2, frames=77, seed=1))
    info = _chunk(b"LIST", b"INFOISFT" + struct.pack("<I", 6) + b"ame!\x00\x00")
    odd = _chunk(b"junk", b"12345")                     # with its pad byte
    return {
        "list_before_data": _riff(fmt16, info, data),
        "list_after_data": _riff(fmt16, data, info),
        "data_before_fmt": _riff(data, fmt16),
        "odd_chunk_before_data": _riff(fmt16, odd, data),
        "odd_data_then_chunk": _riff(
            _fmt(1, 1, 8), _chunk(b"data", _samples(1, 8, 1)), info),
        "two_data_chunks": _riff(fmt16, data, info, other),
        "data_past_eof": _riff(fmt16, _chunk(b"data", _samples(1, 16, 2),
                                             size=1 << 30)),
        "truncated_last_frame": _riff(fmt16, data)[:-2],
        "truncated_mid_sample": _riff(fmt16, data)[:-1],
        "truncated_24bit": _riff(_fmt(1, 2, 24),
                                 _chunk(b"data", _samples(1, 24, 2)))[:-4],
        "riff_size_wrong": _riff(fmt16, data, size=4),
        "empty_data": _riff(fmt16, _chunk(b"data", b"")),
        "missing_data": _riff(fmt16, info),
        "missing_fmt": _riff(info, data),
        "short_fmt": _riff(_chunk(b"fmt ", b"\x01\x00\x02\x00"), data),
        "header_only": _riff(),
        "not_riff": b"RIFX" + _riff(fmt16, data)[4:],
        "tiny": b"RIF",
        "zero_channels": _riff(_fmt(1, 0, 16), data),
        "unsupported_bits": _riff(_fmt(1, 2, 12), data),
    }[name]


LAYOUTS = ["list_before_data", "list_after_data", "data_before_fmt",
           "odd_chunk_before_data", "odd_data_then_chunk", "two_data_chunks",
           "data_past_eof", "truncated_last_frame", "truncated_mid_sample",
           "truncated_24bit", "riff_size_wrong", "empty_data", "missing_data",
           "missing_fmt", "short_fmt", "header_only", "not_riff", "tiny",
           "zero_channels", "unsupported_bits"]


@pytest.mark.parametrize("prefer_int16", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_read_layouts(tmp_path, layout, prefer_int16):
    path = tmp_path / "a.wav"
    path.write_bytes(_layout(layout))
    _assert_same(path, prefer_int16=prefer_int16)


def test_truncated_and_two_chunks_read_what_they_should(tmp_path):
    """The layouts' arrays themselves: the last data chunk wins, a cut
    frame is dropped, a size past the end reads what the file holds."""
    path = tmp_path / "a.wav"
    path.write_bytes(_layout("two_data_chunks"))
    assert port.read_wav(str(path), prefer_int16=True)[0].shape == (77, 2)
    path.write_bytes(_layout("truncated_last_frame"))
    assert port.read_wav(str(path), prefer_int16=True)[0].shape == (
        FRAMES - 1, 2)
    path.write_bytes(_layout("data_past_eof"))
    assert port.read_wav(str(path), prefer_int16=True)[0].shape == (
        FRAMES, 2)


def _aiff(*chunks: bytes, form=b"AIFF") -> bytes:
    inner = form + b"".join(chunks)
    return b"FORM" + struct.pack(">I", len(inner)) + inner


def _achunk(cid, body, size=None):
    size = len(body) if size is None else size
    return cid + struct.pack(">I", size) + body + b"\x00" * (len(body) & 1)


def _comm(channels, bits, frames=FRAMES):
    return _achunk(b"COMM", struct.pack(">HIH", channels, frames, bits)
                   + port._write_extended80(SR))


def _aiff_layout(name):
    rng = np.random.default_rng(3)
    pcm16 = rng.integers(-32768, 32767, FRAMES * 2).astype(">i2").tobytes()
    ssnd = _achunk(b"SSND", struct.pack(">II", 0, 0) + pcm16)
    name_chunk = _achunk(b"NAME", b"abc")                # odd, padded
    return {
        "plain": _aiff(_comm(2, 16), ssnd),
        "aifc": _aiff(_comm(2, 16), ssnd, form=b"AIFC"),
        "name_chunk_first": _aiff(name_chunk, _comm(2, 16), ssnd),
        "ssnd_before_comm": _aiff(ssnd, name_chunk, _comm(2, 16)),
        "ssnd_offset": _aiff(_comm(2, 16), _achunk(
            b"SSND", struct.pack(">II", 4, 0) + b"\x00" * 4 + pcm16)),
        "ssnd_offset_past_body": _aiff(_comm(2, 16), _achunk(
            b"SSND", struct.pack(">II", 1 << 20, 0) + pcm16)),
        "pcm8_mono": _aiff(_comm(1, 8), _achunk(
            b"SSND", struct.pack(">II", 0, 0)
            + rng.integers(0, 256, FRAMES, dtype=np.uint8).tobytes())),
        "pcm24": _aiff(_comm(2, 24), _achunk(
            b"SSND", struct.pack(">II", 0, 0)
            + rng.integers(0, 256, FRAMES * 6, dtype=np.uint8).tobytes())),
        "pcm32": _aiff(_comm(2, 32), _achunk(
            b"SSND", struct.pack(">II", 0, 0)
            + rng.integers(-2 ** 31, 2 ** 31 - 1, FRAMES * 2).astype(
                ">i4").tobytes())),
        "ssnd_past_eof": _aiff(_comm(2, 16), _achunk(
            b"SSND", struct.pack(">II", 0, 0) + pcm16, size=1 << 30)),
        "truncated": _aiff(_comm(2, 16), ssnd)[:-3],
        "short_ssnd": _aiff(_comm(2, 16), _achunk(b"SSND", b"\x00\x00")),
        "missing_ssnd": _aiff(_comm(2, 16)),
        "missing_comm": _aiff(ssnd),
        "not_aiff": b"RIFF" + _aiff(_comm(2, 16), ssnd)[4:],
    }[name]


AIFF_LAYOUTS = ["plain", "aifc", "name_chunk_first", "ssnd_before_comm",
                "ssnd_offset", "ssnd_offset_past_body", "pcm8_mono", "pcm24",
                "pcm32", "ssnd_past_eof", "truncated", "short_ssnd",
                "missing_ssnd", "missing_comm", "not_aiff"]


@pytest.mark.parametrize("layout", AIFF_LAYOUTS)
def test_read_aiff_layouts(tmp_path, layout):
    path = tmp_path / "a.aiff"
    path.write_bytes(_aiff_layout(layout))
    _assert_same(path, "read_aiff")


# -- the returned array -------------------------------------------------------

def _owner(a: np.ndarray) -> np.ndarray:
    while isinstance(a.base, np.ndarray):
        a = a.base
    assert a.base is None, type(a.base)     # numpy's own memory
    return a


@pytest.mark.parametrize("prefer_int16,itemsize", [(True, 2), (False, 4)])
def test_array_is_the_callers_own_and_payload_sized(tmp_path, prefer_int16,
                                                    itemsize):
    """A 1 MB LIST chunk in the file: the array's memory is its samples'."""
    path = tmp_path / "a.wav"
    payload = _samples(1, 16, 2)
    path.write_bytes(_riff(_fmt(1, 2, 16), _chunk(b"LIST", b"\x00" * 2 ** 20),
                           _chunk(b"data", payload)))
    x, _ = port.read_wav(str(path), prefer_int16=prefer_int16)
    assert x.flags.writeable and x.flags.c_contiguous
    assert _owner(x).nbytes == len(payload) // 2 * itemsize
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = torch.from_numpy(x)
    assert t.data_ptr() == x.ctypes.data          # no copy
    first = x[0, 0].copy()
    x[0, 0] = 7                                    # the caller's to change
    assert port.read_wav(str(path), prefer_int16=prefer_int16)[0][0, 0] == \
        first


def _peak_bytes(fn):
    """The most host memory (numpy's and Python's) ``fn`` held at once,
    above what it held when it started; and ``fn``'s result."""
    tracemalloc.start()
    try:
        out = fn()
        return tracemalloc.get_traced_memory()[1], out
    finally:
        tracemalloc.stop()


SLACK = 64 * 1024       # the interpreter's own small objects


@pytest.mark.parametrize("prefer_int16,arrays", [(True, 1), (False, 3)])
def test_decode_holds_no_second_copy(tmp_path, prefer_int16, arrays):
    """PCM16 with ``prefer_int16``: the returned array is all the decode
    holds; to float32: the raw chunk and the output (twice its size)."""
    path = tmp_path / "a.wav"
    payload = _samples(1, 16, 2, frames=200_000)
    path.write_bytes(_riff(_fmt(1, 2, 16), _chunk(b"LIST", b"\x00" * 2 ** 20),
                           _chunk(b"data", payload)))
    peak, _ = _peak_bytes(
        lambda: port.read_wav(str(path), prefer_int16=prefer_int16))
    assert arrays * len(payload) <= peak < arrays * len(payload) + SLACK


@pytest.mark.parametrize("writer", ["write_wav", "write_aiff"])
def test_encode_holds_no_copy_in_the_files_type(tmp_path, writer):
    """int16 samples already in the file's byte order are written from
    their own memory; otherwise one converted array."""
    audio = _int16(200_000)
    if writer == "write_aiff":
        want = audio.nbytes                         # one byte-swapped array
    else:
        want = 0
    peak, _ = _peak_bytes(
        lambda: getattr(port, writer)(str(tmp_path / "o"), audio, SR))
    assert want <= peak < want + SLACK


def test_reads_share_no_memory(tmp_path):
    path = tmp_path / "a.wav"
    path.write_bytes(_riff(_fmt(1, 2, 16), _chunk(b"data", _samples(1, 16, 2))))
    a, _ = port.read_wav(str(path), prefer_int16=True)
    b, _ = port.read_wav(str(path), prefer_int16=True)
    assert not np.shares_memory(a, b)


# -- writes -----------------------------------------------------------------

def _signal(frames=FRAMES, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3, 1.3, (frames, channels))
    x[:3, 0] = [1.0, -1.0, 0.0]
    return x


def _int16(frames=FRAMES):
    return (_signal(frames) * 32767).astype(np.int16)


INPUTS = {
    "int16": lambda: _int16(),
    "int16_big_endian": lambda: _int16().astype(">i2"),
    "int16_strided": lambda: _int16(2 * FRAMES)[::2],
    "int16_fortran": lambda: np.asfortranarray(_int16()),
    "int16_mono_1d": lambda: _int16()[:, 0].copy(),
    "float32": lambda: _signal().astype(np.float32),
    "float64": lambda: _signal(),
    "float32_strided": lambda: _signal(2 * FRAMES).astype(np.float32)[::2],
    "float32_big_endian": lambda: _signal().astype(">f4"),
    "float16": lambda: _signal().astype(np.float16),
    "int32": lambda: (_signal() * 3).astype(np.int32),
    "nan_inf": lambda: np.array([[np.nan, np.inf], [-np.inf, 0.5]]),
    "empty": lambda: np.zeros((0, 2), np.float32),
    "empty_int16": lambda: np.zeros((0, 2), np.int16),
    "one_frame": lambda: _int16()[:1, :1],
}


def _writes_equal(tmp_path, writer, audio, bits):
    paths = [tmp_path / f"{m.__name__.split('.')[0]}.out" for m in (ref, port)]
    results = []
    for mod, p in zip((ref, port), paths):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # nan -> int
            try:
                getattr(mod, writer)(str(p), audio, SR, bits)
                results.append(p.read_bytes())
            except Exception as e:
                results.append(type(e))
    assert results[1] == results[0]


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("name", list(INPUTS))
def test_write_wav_bytes(tmp_path, name, bits):
    _writes_equal(tmp_path, "write_wav", INPUTS[name](), bits)


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("name", list(INPUTS))
def test_write_aiff_bytes(tmp_path, name, bits):
    _writes_equal(tmp_path, "write_aiff", INPUTS[name](), bits)


@pytest.mark.parametrize("writer,bits", [("write_wav", 8),
                                         ("write_aiff", 32)])
def test_write_unsupported_depth(tmp_path, writer, bits):
    _writes_equal(tmp_path, writer, _int16(), bits)


@pytest.mark.parametrize("writer,bits", [("write_wav", 16), ("write_wav", 24),
                                         ("write_aiff", 16),
                                         ("write_aiff", 24)])
def test_write_into_a_fifo(tmp_path, writer, bits):
    """Every byte reaches a reader thread draining a pipe (a master larger
    than the pipe's buffer)."""
    audio = _int16(300_000) if bits == 16 else _signal(300_000)
    want = tmp_path / "want"
    getattr(ref, writer)(str(want), audio, SR, bits)
    fifo = tmp_path / "fifo"
    os.mkfifo(fifo)
    got = []

    def drain():
        with open(fifo, "rb") as f:
            got.append(f.read())

    reader = threading.Thread(target=drain)
    reader.start()
    getattr(port, writer)(str(fifo), audio, SR, bits)
    reader.join(timeout=30)
    assert not reader.is_alive()
    assert got == [want.read_bytes()]


def test_roundtrip_int16(tmp_path):
    audio = _int16()
    path = tmp_path / "a.wav"
    port.write_wav(str(path), audio, SR)
    x, sr = port.read_wav(str(path), prefer_int16=True)
    assert sr == SR and x.dtype == np.int16
    np.testing.assert_array_equal(x, audio)


# -- the host_bytes counter -----------------------------------------------------

def _span(name):
    (s,) = [s for s in telemetry.records() if s.name == name]
    return s


def test_host_bytes_on_the_pcm16_path(tmp_path):
    """``io.decode`` counts the one array it returns; ``io.write`` of
    ``<i2`` C-contiguous samples counts nothing."""
    path = tmp_path / "a.wav"
    payload = _samples(1, 16, 2)
    path.write_bytes(_riff(_fmt(1, 2, 16), _chunk(b"LIST", b"\x00" * 4096),
                           _chunk(b"data", payload)))
    out = tmp_path / "out.wav"
    with telemetry.tracing():
        x, sr = read_audio(str(path), prefer_int16=True)
        write_audio(str(out), x, sr)
    assert _span("io.decode").host_bytes == len(payload)
    assert _span("io.write").host_bytes == 0
    assert out.read_bytes()[44:] == payload


@pytest.mark.parametrize("bits,sample_bytes", [(16, 8 + 2), (24, 8 + 4 + 3)])
def test_host_bytes_on_the_float_paths(tmp_path, bits, sample_bytes):
    """Decode to float32 counts the raw chunk and the output (24-bit: its
    int32 staging too); encode from float64 counts each array it makes."""
    path = tmp_path / "a.wav"
    payload = _samples(1, bits, 2)
    path.write_bytes(_riff(_fmt(1, 2, bits), _chunk(b"data", payload)))
    n = FRAMES * 2
    with telemetry.tracing():
        x, sr = read_audio(str(path))
        write_audio(str(tmp_path / "out.wav"), x.astype(np.float64), sr, bits)
    decode = len(payload) + n * 4 + (n * 4 if bits == 24 else 0)
    assert _span("io.decode").host_bytes == decode
    assert _span("io.write").host_bytes == n * sample_bytes


def test_host_bytes_counts_only_while_tracing(tmp_path):
    path = tmp_path / "a.wav"
    path.write_bytes(_riff(_fmt(1, 2, 16), _chunk(b"data", _samples(1, 16, 2))))
    read_audio(str(path), prefer_int16=True)
    assert telemetry.records() == []
    with telemetry.tracing():
        with telemetry.stage_timer("outer"):
            telemetry.note_host_bytes(5)
            with telemetry.stage_timer("inner"):
                telemetry.note_host_bytes(7)
        telemetry.note_host_bytes(11)          # no span open: dropped
    assert (_span("outer").host_bytes, _span("inner").host_bytes) == (5, 7)
