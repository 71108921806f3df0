"""WAV (RIFF) and AIFF codecs — pure numpy.

Port of ``ame_tpu/io/wav.py`` (``read_wav``, ``write_wav``, ``read_aiff``,
``write_aiff`` and their helpers), a jax-free copy. Supports PCM 8/16/24/32-bit
and float32/float64 WAV (incl. WAVE_FORMAT_EXTENSIBLE), and PCM AIFF. Decode
returns float32 in [-1, 1) using the reference's scaling convention
int / 2^(bits-1) (engine:253). Encode writes int16 by default with
trunc-toward-zero *32767 quantization (engine:255-256) unless the data is
already int16.

Neither direction copies the track through an intermediate buffer: decode
walks the chunk headers on the open file and reads the sample chunk
straight into the array it returns (PCM16 with ``prefer_int16``) or into
one raw array it converts; encode writes the array's own memory when it is
already in the file's sample type and byte order, and one converted array
otherwise. Every sample-sized host array the codec allocates is counted in
the open span's ``host_bytes`` (``utils.telemetry.note_host_bytes``).
Where the caller passes ``into`` (``read_wav``), a PCM16 decode with
``prefer_int16`` reads into the array ``into(nbytes)`` gives instead,
which the caller counts. A sample chunk of two ranges or more
(``_RANGE_BYTES`` each) is read as that many contiguous positioned reads
at once, the calling thread's and the process's shared reader threads'.
"""

from __future__ import annotations

import os
import struct
import threading
from concurrent import futures

import numpy as np

from ame_tpu_torch.ops._count import bump
from ame_tpu_torch.utils.telemetry import note_host_bytes

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# A split read's ranges hold at least this many bytes each, and start at
# multiples of _PAGE_BYTES inside the destination.
_RANGE_BYTES = 4 << 20
_PAGE_BYTES = 4096

_readers = None   # (pid, executor or None, workers), made at first use
_readers_lock = threading.Lock()


def _new(a: np.ndarray) -> np.ndarray:
    """``a``, a host array the codec just allocated, counted."""
    note_host_bytes(a.nbytes)
    return a


def _decode_pcm(raw: np.ndarray, bits: int, fmt: int,
                big_endian: bool = False) -> np.ndarray:
    """The samples of ``raw`` (uint8) as float32, in one new array (24-bit:
    two). The arithmetic is the reference's, done in place: each step is
    exact or rounds once, as there."""
    bo = ">" if big_endian else "<"
    if fmt == _WAVE_FORMAT_IEEE_FLOAT:
        dt = np.dtype(f"{bo}f4" if bits == 32 else f"{bo}f8")
        return _new(np.frombuffer(raw, dt).astype(np.float32))
    if bits == 8 and not big_endian:
        # WAV 8-bit is unsigned
        x = _new(raw.astype(np.float32))
        x -= 128.0
        x /= 128.0
        return x
    if bits == 8:
        x = _new(raw.view(np.int8).astype(np.float32))
        x /= 128.0
        return x
    if bits == 16:
        x = _new(np.frombuffer(raw, np.dtype(f"{bo}i2")).astype(np.float32))
        x /= 32768.0
        return x
    if bits == 24:
        b = raw.reshape(-1, 3)
        # each sample as the top three bytes of an int32, then shifted down:
        # the shift sign-extends
        w = _new(np.zeros((len(b), 4), np.uint8))
        if big_endian:
            w[:, :3] = b
            v = w.view(">i4").reshape(-1)
        else:
            w[:, 1:] = b
            v = w.view("<i4").reshape(-1)
        v >>= 8
        x = _new(v.astype(np.float32))
        x /= 8388608.0
        return x
    if bits == 32:
        # int32 -> float32 rounds once, as int32 -> float64 -> float32 does
        # after the exact division by 2^31
        x = _new(np.frombuffer(raw, np.dtype(f"{bo}i4")).astype(np.float32))
        x /= 2147483648.0
        return x
    raise ValueError(f"unsupported PCM bit depth: {bits}")


def _chunks(f, size_fmt: str):
    """Walk the chunks after the 12-byte form header of the open file
    ``f``: yields (id, declared size, body offset, bytes the file holds of
    the body), leaving ``f`` anywhere; odd sizes skip their pad byte."""
    end = os.fstat(f.fileno()).st_size
    pos = 12
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        (size,) = struct.unpack(size_fmt, head[4:8])
        yield head[:4], size, pos + 8, min(size, end - pos - 8)
        pos += 8 + size + (size & 1)


def _body(f, offset: int, n: int) -> bytes:
    """A small chunk body (header fields), ``n`` bytes at ``offset``."""
    f.seek(offset)
    return f.read(n)


def _reader_pool():
    """The process's reader threads, shared by every thread that decodes
    (served workers, ``fleet``), and their number: one fewer than the
    CPUs the process may use, at most 7; (None, 0) where that is 0 or the
    platform has no positioned scatter read. Made again in a forked
    child, which has none of its parent's threads."""
    global _readers
    with _readers_lock:
        if _readers is None or _readers[0] != os.getpid():
            n = (min(7, len(os.sched_getaffinity(0)) - 1)
                 if hasattr(os, "preadv") else 0)
            pool = (futures.ThreadPoolExecutor(
                n, thread_name_prefix="ame-wav-read") if n > 0 else None)
            _readers = (os.getpid(), pool, n)
        return _readers[1], _readers[2]


def _read_range(fd: int, view: np.ndarray, offset: int, a: int,
                b: int) -> int:
    """The file's bytes at ``offset + a`` read into ``view[a:b]``: the
    count read, short only at the end of the file."""
    got = a
    while got < b:
        n = os.preadv(fd, [view[got:b]], offset + got)
        if not n:
            break
        got += n
    return got - a


def _read_split(fd: int, view: np.ndarray, offset: int, nbytes: int,
                pool, t: int) -> int:
    """``nbytes`` at ``offset`` read into ``view`` as ``t`` contiguous
    ranges at once, the first on the calling thread and the rest on
    ``pool``: the bytes of the prefix read from the start, up to the first
    range that came back short. Returns, or raises the first range's
    error, only once no range is still writing into ``view``."""
    step = -(-nbytes // t)
    step = -(-step // _PAGE_BYTES) * _PAGE_BYTES
    edges = [min(i * step, nbytes) for i in range(t + 1)]
    jobs = []
    try:
        for a, b in zip(edges[1:-1], edges[2:]):
            jobs.append(pool.submit(_read_range, fd, view, offset, a, b))
        counts = [_read_range(fd, view, offset, edges[0], edges[1])]
    finally:
        futures.wait(jobs)
    counts += [j.result() for j in jobs]
    bump(_read_samples, "split_reads")
    bump(_read_samples, "ranges", t)
    got = 0
    for a, b, n in zip(edges, edges[1:], counts):
        got += n
        if n < b - a:
            break
    return got


def _read_samples(f, offset: int, nbytes: int, dtype: str,
                  into=None) -> np.ndarray:
    """``nbytes`` at ``offset`` read into a new 1-D ``dtype`` array of the
    whole samples read; ValueError where ``nbytes`` is no whole number of
    samples, as ``np.frombuffer`` over the bytes raises. ``into``: read
    into ``into(nbytes)``, a writable uint8 array, instead.

    From 2 ``_RANGE_BYTES`` on, the bytes are read as ranges at once, as
    many as fit, up to one more than the reader threads (``_read_split``);
    below that, or without reader threads, in one sequential read.
    ``_read_samples.split_reads`` counts the reads split,
    ``_read_samples.ranges`` their ranges."""
    dt = np.dtype(dtype)
    if nbytes % dt.itemsize:
        raise ValueError("buffer size must be a multiple of element size")
    view = (into(nbytes) if into is not None
            else _new(np.empty(nbytes // dt.itemsize, dt)).view(np.uint8))
    x = view.view(dt)
    pool, workers = (_reader_pool() if nbytes >= 2 * _RANGE_BYTES
                     else (None, 0))
    t = min(1 + workers, nbytes // _RANGE_BYTES)
    if t > 1:
        got = _read_split(f.fileno(), view, offset, nbytes, pool, t)
    else:
        f.seek(offset)
        got = 0
        while got < nbytes:            # short only at the end of the file
            n = f.readinto(view[got:])
            if not n:
                break
            got += n
    return x[:got // dt.itemsize]


_read_samples.split_reads = 0
_read_samples.ranges = 0


def read_wav(path: str, prefer_int16: bool = False, *, into=None):
    """Returns (audio [N, C], sample_rate int).

    ``prefer_int16``: for PCM16 files, return the raw int16 samples instead
    of converting to float32 — the pipeline uploads int16 and converts on
    the device; ``into``, where given, makes the array they are read into
    (``nbytes`` -> writable uint8). Non-PCM16 files still return float32.

    The array is the caller's own: writable, C-contiguous, and backed by
    memory the size of the sample chunk, not of the file."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        for cid, size, offset, held in _chunks(f, "<I"):
            if cid == b"fmt ":
                body = _body(f, offset, held)
                (tag, channels, rate, _br, _ba, bits) = struct.unpack(
                    "<HHIIHH", body[:16])
                if tag == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    # subformat GUID lead
                    (tag,) = struct.unpack("<H", body[24:26])
                fmt = (tag, channels, rate, bits)
            elif cid == b"data":
                data = (offset, held)
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        tag, channels, rate, bits = fmt
        if prefer_int16 and tag == _WAVE_FORMAT_PCM and bits == 16:
            x = _read_samples(f, *data, "<i2", into=into)
        else:
            x = _decode_pcm(_read_samples(f, *data, "u1"), bits, tag)
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels), rate


def _as_written(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` in the file's sample type ``dtype``, C-contiguous: ``a``
    itself where it already is, else one new array."""
    if a.dtype == np.dtype(dtype) and a.flags.c_contiguous:
        return a
    return _new(np.ascontiguousarray(a, dtype))


def _quantized(audio: np.ndarray, scale: float) -> np.ndarray:
    """trunc(clip(audio, -1, 1) * scale), in one new float array."""
    t = _new(np.clip(audio, -1.0, 1.0))
    t *= scale
    return np.trunc(t, out=t)


def _pcm24(audio: np.ndarray, big_endian: bool) -> np.ndarray:
    """[N * C, 3] uint8: each sample's 24-bit two's complement."""
    bo = ">" if big_endian else "<"
    v = _new(_quantized(audio, 8388607.0).astype(f"{bo}i4", order="C"))
    b = v.view(np.uint8).reshape(-1, 4)
    return _new(np.ascontiguousarray(b[:, 1:] if big_endian else b[:, :3]))


def _write(f, a: np.ndarray) -> None:
    """Write the C-contiguous ``a``'s memory, uncopied."""
    f.write(a.reshape(-1).view(np.uint8))


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """audio: [N, C] float in [-1, 1], or int16 samples for ``bits=16``."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    n, c = audio.shape
    if bits == 16:
        if audio.dtype == np.int16:
            pcm = _as_written(audio, "<i2")   # pre-quantized samples
        else:
            pcm = _new(_quantized(audio, 32767.0).astype("<i2", order="C"))
        tag = _WAVE_FORMAT_PCM
    elif bits == 24:
        pcm = _pcm24(audio, big_endian=False)
        tag = _WAVE_FORMAT_PCM
    elif bits == 32:
        pcm = _as_written(audio, "<f4")
        tag = _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported write depth: {bits}")
    block = c * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + pcm.nbytes, b"WAVE",
        b"fmt ", 16, tag, c, int(sample_rate),
        int(sample_rate) * block, block, bits,
        b"data", pcm.nbytes)
    with open(path, "wb") as f:
        f.write(hdr)
        _write(f, pcm)


# ---------------------------------------------------------------------------
# AIFF
# ---------------------------------------------------------------------------

def _read_extended80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF sample rate field)."""
    (se,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:10])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def _write_extended80(rate: float) -> bytes:
    """Encode a positive sample rate as the AIFF 80-bit extended float."""
    if rate <= 0:
        return b"\x00" * 10
    exp = 0
    mant = float(rate)
    while mant >= 2.0:
        mant /= 2.0
        exp += 1
    while mant < 1.0:
        mant *= 2.0
        exp -= 1
    return struct.pack(">HQ", exp + 16383, int(mant * (1 << 63)))


def write_aiff(path: str, audio: np.ndarray, sample_rate: int,
               bits: int = 16) -> None:
    """audio: [N, C] float in [-1, 1] (or int16 for 16-bit); PCM 16/24."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    n, c = audio.shape
    if bits == 16:
        if audio.dtype == np.int16:
            pcm = _as_written(audio, ">i2")  # pre-quantized
        else:
            pcm = _new(_quantized(audio, 32767.0).astype(">i2", order="C"))
    elif bits == 24:
        pcm = _pcm24(audio, big_endian=True)
    else:
        raise ValueError(f"unsupported AIFF write depth: {bits}")
    comm = struct.pack(">HIH", c, n, bits) + _write_extended80(sample_rate)
    ssnd = 8 + pcm.nbytes          # the offset and block-size words first
    pad = ssnd & 1
    form = 4 + 8 + len(comm) + (len(comm) & 1) + 8 + ssnd + pad
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", form) + b"AIFF"
                + b"COMM" + struct.pack(">I", len(comm)) + comm
                + b"\x00" * (len(comm) & 1)
                + b"SSND" + struct.pack(">III", ssnd, 0, 0))
        _write(f, pcm)
        f.write(b"\x00" * pad)


def read_aiff(path: str):
    """Returns (audio [N, C] float32, sample_rate int)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"FORM" or head[8:12] not in (b"AIFF", b"AIFC"):
            raise ValueError(f"{path}: not an AIFF file")
        comm = None
        ssnd = None
        for cid, _size, offset, held in _chunks(f, ">I"):
            if cid == b"COMM":
                body = _body(f, offset, held)
                channels, _frames, bits = struct.unpack(">HIH", body[:8])
                rate = _read_extended80(body[8:18])
                comm = (channels, bits, int(round(rate)))
            elif cid == b"SSND":
                (skip, _blk) = struct.unpack(
                    ">II", _body(f, offset, min(held, 8)))
                ssnd = (offset + 8 + skip, max(held - 8 - skip, 0))
        if comm is None or ssnd is None:
            raise ValueError(f"{path}: missing COMM/SSND chunk")
        channels, bits, rate = comm
        x = _decode_pcm(_read_samples(f, *ssnd, "u1"), bits,
                        _WAVE_FORMAT_PCM, big_endian=True)
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels), rate
