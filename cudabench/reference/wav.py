"""16-bit PCM WAV bytes <-> int16 samples, for the reference and the
harness's own inputs. Plain numpy; nothing of the program."""

from __future__ import annotations

import struct

import numpy as np


def encode(pcm: np.ndarray, sample_rate: int) -> bytes:
    """The canonical 44-byte header (PCM, 16 bit) and the int16 payload of
    [N, C] samples."""
    pcm = np.ascontiguousarray(pcm, dtype="<i2")
    n, c = pcm.shape
    payload = pcm.tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload),
                         b"WAVE", b"fmt ", 16, 1, c, sample_rate,
                         sample_rate * 2 * c, 2 * c, 16, b"data",
                         len(payload))
    return header + payload


def decode(data) -> tuple[np.ndarray, int]:
    """(int16 [N, C], sample rate) of a 16-bit PCM WAV held in ``data``;
    raises ValueError on any other format."""
    data = memoryview(data)
    if bytes(data[:4]) != b"RIFF" or bytes(data[8:12]) != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, body = 12, None, None
    while pos + 8 <= len(data):
        cid = bytes(data[pos:pos + 4])
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", data[pos + 8:pos + 24])
        elif cid == b"data":
            body = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    if fmt is None or body is None:
        raise ValueError("missing fmt or data chunk")
    tag, channels, rate, _, _, bits = fmt
    if tag != 1 or bits != 16:
        raise ValueError(f"not 16-bit PCM (format {tag}, {bits} bits)")
    pcm = np.frombuffer(body, dtype="<i2")
    n = len(pcm) // channels
    return pcm[:n * channels].reshape(n, channels), rate
