"""A large sample chunk is read as contiguous positioned reads at once
(``ame_tpu_torch/io/wav._read_samples``): from 2 ``_RANGE_BYTES`` on, as
many ranges as fit, up to one more than the process's reader threads.
Held on the CPU against ``ame_tpu.io.wav`` and against the same codec's
sequential read: the same arrays, or the same exception, from files on
both sides of the threshold; a range that comes back short or raises;
two threads decoding at once; and the ``split_reads`` / ``ranges``
counters."""

import os
import struct
import sys
import threading
import time

import numpy as np
import pytest

from ame_tpu.io import wav as ref
from ame_tpu_torch.io import wav as port

SR = 44100
R = port._RANGE_BYTES
# data chunk sizes in bytes, each made a whole number of frames: half the
# threshold, the last frame below it, at it, and 3.3 ranges
SIZES = {"half": R // 2, "under": 2 * R - 1, "at": 2 * R,
         "many": int(3.3 * R)}
# (reader, format tag, bits, read_wav's prefer_int16)
FORMATS = {
    "pcm16_int16": ("read_wav", 1, 16, True),
    "pcm16_float": ("read_wav", 1, 16, False),
    "pcm8": ("read_wav", 1, 8, False),
    "pcm24": ("read_wav", 1, 24, False),
    "pcm32": ("read_wav", 1, 32, False),
    "float32": ("read_wav", 3, 32, False),
    "float64": ("read_wav", 3, 64, False),
    "aiff16": ("read_aiff", 1, 16, False),
}


@pytest.fixture
def cpus(monkeypatch):
    """``cpus(n)``: the process may use ``n`` CPUs, and the reader pool is
    made anew for that; shut down after the test."""
    def set_(n):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid: set(range(n)))
        monkeypatch.setattr(port, "_readers", None)
    yield set_
    if port._readers is not None and port._readers[1] is not None:
        port._readers[1].shutdown(wait=True)


@pytest.fixture
def counts(monkeypatch):
    """The counters zeroed; ``counts()`` reads them."""
    monkeypatch.setattr(port._read_samples, "split_reads", 0)
    monkeypatch.setattr(port._read_samples, "ranges", 0)
    return lambda: (port._read_samples.split_reads,
                    port._read_samples.ranges)


def _frames(size: str, frame: int) -> int:
    """The frame count of ``SIZES[size]``: below the threshold the most
    under it, at or above it the fewest reaching it; odd where it can be."""
    n = SIZES[size]
    if size == "under":
        return n // frame
    k = -(-n // frame)
    return k if size == "at" else k | 1


def _payload(bits: int, tag: int, n: int, seed: int) -> bytes:
    """``n`` samples: floats in [-1.2, 1.2], integers of every bit pattern."""
    rng = np.random.default_rng(seed)
    if tag == 3:
        x = rng.random(n, np.float32 if bits == 32 else np.float64)
        return (x * 2.4 - 1.2).tobytes()
    return rng.bytes(n * bits // 8)


def _file(path, fmt: str, size: str, channels: int = 2, seed: int = 0,
          declared: int | None = None, cut: int = 0) -> str:
    """A WAV or AIFF of ``fmt`` with a data chunk of ``SIZES[size]``;
    ``declared``: the chunk's size field, ``cut``: bytes cut off the end."""
    reader, tag, bits, _ = FORMATS[fmt]
    frames = _frames(size, channels * bits // 8)
    body = _payload(bits, tag, frames * channels, seed)
    if reader == "read_aiff":
        comm = struct.pack(">HIH", channels, frames, bits) + \
            port._write_extended80(SR)
        ssnd = struct.pack(">II", 0, 0) + body
        size_ = len(ssnd) if declared is None else declared
        inner = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
                 + b"SSND" + struct.pack(">I", size_) + ssnd)
        data = b"FORM" + struct.pack(">I", len(inner)) + inner
    else:
        block = channels * bits // 8
        fmt_ = struct.pack("<HHIIHH", tag, channels, SR, SR * block, block,
                           bits)
        size_ = len(body) if declared is None else declared
        inner = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_
                 + b"data" + struct.pack("<I", size_) + body)
        data = b"RIFF" + struct.pack("<I", len(inner)) + inner
    p = str(path)
    with open(p, "wb") as f:
        f.write(data[:len(data) - cut])
    return p


def _read(mod, path, fmt, **kw):
    """``mod``'s (array, rate) of the file, or its exception's type."""
    reader, _, _, prefer = FORMATS[fmt]
    if reader == "read_wav":
        kw["prefer_int16"] = prefer
    try:
        return getattr(mod, reader)(path, **kw)
    except Exception as e:          # the type is what is compared
        return type(e)


def _sequential(path, fmt, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.setattr(port, "_RANGE_BYTES", 1 << 62)
        return _read(port, path, fmt, **kw)


def _same(a, b):
    if isinstance(a, type) or isinstance(b, type):
        assert a is b, (a, b)
        return
    assert a[1] == b[1]
    assert a[0].dtype == b[0].dtype and a[0].shape == b[0].shape
    np.testing.assert_array_equal(a[0], b[0])


def _into(nbytes):
    """A destination like the staging's block: page-aligned, larger than
    asked for, filled with a pattern that a missed byte would show."""
    buf = np.full(nbytes + 3 * 4096, 0xA5, np.uint8)
    start = -buf.ctypes.data % 4096
    return buf[start:start + nbytes]


def _step(nbytes: int, t: int) -> int:
    """The length of each of ``t`` ranges but the last."""
    return -(-(-(-nbytes // t)) // 4096) * 4096


def _expected_ranges(nbytes: int, workers: int) -> int:
    t = min(1 + workers, nbytes // R)
    return t if t > 1 else 0


# -- the same arrays ----------------------------------------------------------

@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_split_read_is_the_sequential_read(tmp_path, fmt, size, cpus,
                                           counts, monkeypatch):
    cpus(8)
    path = _file(tmp_path / "a", fmt, size, seed=len(fmt))
    got = _read(port, path, fmt)
    n = counts()
    _same(_read(ref, path, fmt), got)
    _same(_sequential(path, fmt, monkeypatch), got)
    assert not isinstance(got, type)
    nbytes = got[0].size * (FORMATS[fmt][2] // 8)
    t = _expected_ranges(nbytes, 7)
    assert n == ((1, t) if t else (0, 0))


@pytest.mark.parametrize("size", list(SIZES))
def test_pcm16_into_a_destination(tmp_path, size, cpus, counts,
                                  monkeypatch):
    """The PCM16 decode into ``into(nbytes)``, the staging's route: the
    returned samples are the destination's, and equal to the reference's."""
    cpus(4)
    path = _file(tmp_path / "a", "pcm16_int16", size, seed=3)
    dest = []

    def into(nbytes):
        dest.append(_into(nbytes))
        return dest[-1]

    got = _read(port, path, "pcm16_int16", into=into)
    assert got[0].ctypes.data == dest[0].ctypes.data
    _same(_read(ref, path, "pcm16_int16"), got)
    _same(_sequential(path, "pcm16_int16", monkeypatch, into=_into), got)
    t = _expected_ranges(dest[0].nbytes, 3)
    assert counts() == ((1, t) if t else (0, 0))


# -- short files and errors ---------------------------------------------------

@pytest.mark.parametrize("fmt", ["pcm16_int16", "pcm16_float", "pcm24",
                                 "aiff16"])
@pytest.mark.parametrize("declared,cut", [(1 << 30, 0), (None, 4), (None, 1),
                                          (None, R + 3)])
def test_truncated_chunk_reads_as_before(tmp_path, fmt, declared, cut, cpus,
                                         counts, monkeypatch):
    """A chunk that claims more than the file holds, or a file cut short
    (a whole frame, mid-sample, mid-range): what the sequential read and
    the reference give, array or exception."""
    cpus(8)
    path = _file(tmp_path / "a", fmt, "many", declared=declared, cut=cut)
    got = _read(port, path, fmt)
    _same(_read(ref, path, fmt), got)
    _same(_sequential(path, fmt, monkeypatch), got)


def test_whole_samples_or_value_error(tmp_path, cpus):
    cpus(8)
    path = _file(tmp_path / "a", "pcm16_int16", "many")
    with open(path, "rb") as f:
        with pytest.raises(ValueError, match="multiple of element size"):
            port._read_samples(f, 44, 3 * R + 1, "<i2")
        assert port._read_samples(f, 44, 3 * R, "<i2").size == 3 * R // 2


def _preadv_with(fault):
    """``os.preadv`` with ``fault(a)`` run first on each call, ``a`` the
    call's byte offset inside the data chunk (44 bytes into the file)."""
    real = os.preadv

    def preadv(fd, bufs, offset):
        r = fault(offset - 44)
        return real(fd, bufs, offset) if r is None else r
    return preadv


def test_a_short_range_ends_the_prefix(tmp_path, cpus, counts, monkeypatch):
    """A range that comes back short (here the second of three, as where
    the file shrank under the read): the whole samples before its end, as
    far as it got, though the range after it read in full."""
    cpus(8)
    path = _file(tmp_path / "a", "pcm16_int16", "many")
    step = _step(_frames("many", 4) * 4, 3)
    real = port._read_range

    def short(fd, view, offset, a, b):
        return real(fd, view, offset, a, a + 1002 if a == step else b)

    monkeypatch.setattr(port, "_read_range", short)
    x, _ = port.read_wav(path, prefer_int16=True)
    assert counts() == (1, 3)
    assert x.shape == ((step + 1002) // 2 // 2, 2)
    want = _sequential(path, "pcm16_int16", monkeypatch)[0]
    np.testing.assert_array_equal(x, want[:len(x)])


@pytest.mark.parametrize("bad", [0, 1], ids=["callers_range", "pool_range"])
def test_an_error_in_one_range_reaches_the_caller_after_every_range(
        tmp_path, cpus, counts, monkeypatch, bad):
    """An OSError in the first of three ranges (the calling thread's) or
    the second (a reader thread's) is raised once the ranges on the
    reader threads, slowed down, have finished writing; the next decode
    is right."""
    cpus(8)
    path = _file(tmp_path / "a", "pcm16_int16", "many", channels=1,
                 seed=5)
    step = _step(_frames("many", 2) * 2, 3)

    def fault(a):
        if a == bad * step:
            raise OSError(5, "injected read error")
        if a:
            time.sleep(0.05)       # still running when the fault is raised

    dest = []

    def into(n):
        dest.append(np.zeros(n, np.uint8))
        return dest[-1]

    with monkeypatch.context() as m:
        m.setattr(os, "preadv", _preadv_with(fault))
        with pytest.raises(OSError, match="injected read error"):
            port.read_wav(path, prefer_int16=True, into=into)
    seen = dest[0].copy()
    time.sleep(0.1)
    np.testing.assert_array_equal(dest[0], seen)    # no range still writing
    assert seen[(1 - bad) * step:(2 - bad) * step].any()
    assert seen[2 * step:].any()
    assert counts() == (0, 0)
    x, _ = port.read_wav(path, prefer_int16=True)
    _same(_read(ref, path, "pcm16_int16"), (x, SR))
    assert counts() == (1, 3)


# -- threads ------------------------------------------------------------------

def test_two_threads_decode_at_once(tmp_path, cpus, counts):
    """Two callers share the one pool (2 workers here, so their ranges
    queue behind each other's) and both read right, again and again."""
    cpus(3)
    paths = [_file(tmp_path / f"{i}", "pcm16_int16", "many", seed=10 + i)
             for i in range(2)]
    want = [_read(ref, p, "pcm16_int16")[0] for p in paths]
    start = threading.Barrier(2)
    errors, pools = [], set()

    def run(i):
        try:
            start.wait(timeout=30)
            for _ in range(4):
                x, _ = port.read_wav(paths[i], prefer_int16=True)
                np.testing.assert_array_equal(x, want[i])
                pools.add(id(port._reader_pool()[0]))
        except Exception as e:     # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(pools) == 1
    assert counts() == (8, 8 * 3)
    names = {t.name for t in threading.enumerate()}
    assert any(n.startswith("ame-wav-read") for n in names), names


# -- the pool and the counters ------------------------------------------------

@pytest.mark.parametrize("cpu,workers", [(1, 0), (2, 1), (8, 7), (64, 7)])
def test_workers_follow_the_cpus(cpus, cpu, workers):
    cpus(cpu)
    pool, n = port._reader_pool()
    assert n == workers and (pool is None) == (workers == 0)
    assert port._reader_pool()[0] is pool         # made once


def test_a_forked_child_makes_its_own_pool(cpus, monkeypatch):
    cpus(4)
    pool = port._reader_pool()[0]
    monkeypatch.setattr(os, "getpid", lambda: -1)
    assert port._reader_pool()[0] not in (pool, None)
    pool.shutdown(wait=True)


@pytest.mark.parametrize("cpu,size,ranges", [
    (8, "many", 3), (8, "at", 2), (8, "under", 0), (8, "half", 0),
    (2, "many", 2), (1, "many", 0), (1, "at", 0)])
def test_counters_and_range_starts(tmp_path, cpus, counts, monkeypatch, cpu,
                                   size, ranges):
    """``ranges`` ranges (0: one sequential read), each starting at a
    multiple of 4096 bytes of the destination, counted once a decode."""
    cpus(cpu)
    path = _file(tmp_path / "a", "pcm16_int16", size, seed=7)
    starts = []

    def note(a):
        starts.append(a)
    monkeypatch.setattr(os, "preadv", _preadv_with(note))
    x, _ = port.read_wav(path, prefer_int16=True)
    _same(_read(ref, path, "pcm16_int16"), (x, SR))
    assert counts() == ((1, ranges) if ranges else (0, 0))
    assert len(starts) == ranges          # one positioned read a range here
    assert all(a % 4096 == 0 for a in starts)
    x, _ = port.read_wav(path, prefer_int16=True)
    assert counts() == ((2, 2 * ranges) if ranges else (0, 0))
