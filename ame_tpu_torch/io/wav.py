"""WAV (RIFF) and AIFF codecs — pure numpy.

Port of ``ame_tpu/io/wav.py`` (``read_wav``, ``write_wav``, ``read_aiff``,
``write_aiff`` and their helpers), a jax-free copy. Supports PCM 8/16/24/32-bit
and float32/float64 WAV (incl. WAVE_FORMAT_EXTENSIBLE), and PCM AIFF. Decode
returns float32 in [-1, 1) using the reference's scaling convention
int / 2^(bits-1) (engine:253). Encode writes int16 by default with
trunc-toward-zero *32767 quantization (engine:255-256) unless the data is
already int16.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_pcm(raw: bytes, bits: int, fmt: int, big_endian: bool = False):
    bo = ">" if big_endian else "<"
    if fmt == _WAVE_FORMAT_IEEE_FLOAT:
        dt = np.dtype(f"{bo}f4" if bits == 32 else f"{bo}f8")
        return np.frombuffer(raw, dt).astype(np.float32)
    if bits == 8 and not big_endian:
        # WAV 8-bit is unsigned
        return ((np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0)
                / 128.0)
    if bits == 8:
        return np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    if bits == 16:
        return (np.frombuffer(raw, np.dtype(f"{bo}i2")).astype(np.float32)
                / 32768.0)
    if bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if big_endian:
            val = (b[:, 0].astype(np.int32) << 16) | \
                  (b[:, 1].astype(np.int32) << 8) | b[:, 2].astype(np.int32)
        else:
            val = (b[:, 2].astype(np.int32) << 16) | \
                  (b[:, 1].astype(np.int32) << 8) | b[:, 0].astype(np.int32)
        val = (val << 8) >> 8  # sign-extend
        return val.astype(np.float32) / 8388608.0
    if bits == 32:
        return (np.frombuffer(raw, np.dtype(f"{bo}i4")).astype(np.float64)
                / 2147483648.0).astype(np.float32)
    raise ValueError(f"unsupported PCM bit depth: {bits}")


def _read_file(path: str) -> bytearray:
    """The whole file as a bytearray: arrays decoded from it are writable,
    so ``torch.from_numpy`` can take them without a copy or a warning."""
    with open(path, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    return data


def read_wav(path: str, prefer_int16: bool = False):
    """Returns (audio [N, C], sample_rate int).

    ``prefer_int16``: for PCM16 files, return the raw int16 samples instead
    of converting to float32 — the pipeline uploads int16 and converts on
    the device. Non-PCM16 files still return float32."""
    data = _read_file(path)
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    audio = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            (tag, channels, rate, _br, _ba, bits) = struct.unpack(
                "<HHIIHH", body[:16])
            if tag == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                (tag,) = struct.unpack("<H", body[24:26])  # subformat GUID lead
            fmt = (tag, channels, rate, bits)
        elif cid == b"data":
            audio = body
        pos += 8 + size + (size & 1)
    if fmt is None or audio is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, rate, bits = fmt
    if prefer_int16 and tag == _WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(audio, np.dtype("<i2"))
    else:
        x = _decode_pcm(audio, bits, tag)
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels), rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """audio: [N, C] float in [-1, 1], or int16 samples for ``bits=16``."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    n, c = audio.shape
    if bits == 16:
        if audio.dtype == np.int16:
            pcm = audio.astype("<i2", copy=False)   # pre-quantized samples
        else:
            pcm = np.trunc(np.clip(audio, -1.0, 1.0)
                           * 32767.0).astype("<i2")
        payload = pcm.tobytes()
        tag = _WAVE_FORMAT_PCM
    elif bits == 24:
        v = np.trunc(np.clip(audio, -1.0, 1.0) * 8388607.0).astype(np.int32)
        b = np.empty((v.size, 3), np.uint8)
        flat = v.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
        tag = _WAVE_FORMAT_PCM
    elif bits == 32:
        payload = audio.astype("<f4").tobytes()
        tag = _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported write depth: {bits}")
    block = c * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(payload), b"WAVE",
        b"fmt ", 16, tag, c, int(sample_rate),
        int(sample_rate) * block, block, bits,
        b"data", len(payload))
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(payload)


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
            payload = audio.astype(">i2").tobytes()  # pre-quantized
        else:
            payload = np.trunc(
                np.clip(audio, -1.0, 1.0) * 32767.0).astype(">i2").tobytes()
    elif bits == 24:
        v = np.trunc(np.clip(audio, -1.0, 1.0) * 8388607.0).astype(np.int32)
        b = np.empty((v.size, 3), np.uint8)
        flat = v.reshape(-1)
        b[:, 0] = (flat >> 16) & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = flat & 0xFF
        payload = b.tobytes()
    else:
        raise ValueError(f"unsupported AIFF write depth: {bits}")
    comm = struct.pack(">HIH", c, n, bits) + _write_extended80(sample_rate)
    ssnd = struct.pack(">II", 0, 0) + payload
    chunks = b""
    for cid, body in ((b"COMM", comm), (b"SSND", ssnd)):
        chunks += cid + struct.pack(">I", len(body)) + body
        if len(body) & 1:
            chunks += b"\x00"
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", 4 + len(chunks)) + b"AIFF")
        f.write(chunks)


def read_aiff(path: str):
    """Returns (audio [N, C] float32, sample_rate int)."""
    data = _read_file(path)
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not an AIFF file")
    pos = 12
    comm = None
    ssnd = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            channels, _frames, bits = struct.unpack(">HIH", body[:8])
            rate = _read_extended80(body[8:18])
            comm = (channels, bits, int(round(rate)))
        elif cid == b"SSND":
            (offset, _blk) = struct.unpack(">II", body[:8])
            ssnd = body[8 + offset:]
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise ValueError(f"{path}: missing COMM/SSND chunk")
    channels, bits, rate = comm
    x = _decode_pcm(ssnd, bits, _WAVE_FORMAT_PCM, big_endian=True)
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels), rate
