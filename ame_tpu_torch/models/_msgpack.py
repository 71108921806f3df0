"""Reader for flax's checkpoint format (``flax.serialization.to_bytes``),
in pure Python: the port needs neither flax nor msgpack.

The file is a nested msgpack map of ``str`` to ext type 1; the ext payload
is itself msgpack, the tuple ``(shape, dtype name, raw C-order bytes)`` of
one numpy array. The reader knows the msgpack types such a file uses (maps,
strings, binary, short arrays, unsigned ints, ext) and raises ``ValueError``
on anything else.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1

# first byte -> (size of the length field, kind) for the sized types
_SIZED = {
    0xc4: (1, "bin"), 0xc5: (2, "bin"), 0xc6: (4, "bin"),
    0xc7: (1, "ext"), 0xc8: (2, "ext"), 0xc9: (4, "ext"),
    0xcc: (1, "uint"), 0xcd: (2, "uint"), 0xce: (4, "uint"),
    0xd9: (1, "str"), 0xda: (2, "str"), 0xdb: (4, "str"),
    0xdc: (2, "array"),
    0xde: (2, "map"), 0xdf: (4, "map"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


def unpackb(data: bytes):
    """Decode one msgpack document; ndarray ext leaves become numpy
    arrays."""
    buf = memoryview(data)
    obj, pos = _read(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj


def load(path: str) -> dict:
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a checkpoint (top level is "
                         f"{type(tree).__name__})")
    return tree


def _take(buf: memoryview, pos: int, n: int):
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated input")
    return buf[pos:pos + n], pos + n


def _read(buf: memoryview, pos: int):
    head, pos = _take(buf, pos, 1)
    b = head[0]
    if b <= 0x7f:                                   # positive fixint
        return b, pos
    if 0x80 <= b <= 0x8f:
        return _map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        raw, pos = _take(buf, pos, b & 0x1f)
        return str(raw, "utf-8"), pos
    if b in _FIXEXT:
        return _ext(buf, pos, _FIXEXT[b])
    if b not in _SIZED:
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
    size, kind = _SIZED[b]
    field, pos = _take(buf, pos, size)
    n = struct.unpack(_UINT[size], field)[0]
    if kind == "uint":
        return n, pos
    if kind == "map":
        return _map(buf, pos, n)
    if kind == "array":
        return _array(buf, pos, n)
    if kind == "ext":
        return _ext(buf, pos, n)
    raw, pos = _take(buf, pos, n)
    return (bytes(raw) if kind == "bin" else str(raw, "utf-8")), pos


def _map(buf: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _read(buf, pos)
        if not isinstance(key, str):
            raise ValueError(f"msgpack: map key {key!r} is not a string")
        out[key], pos = _read(buf, pos)
    return out, pos


def _array(buf: memoryview, pos: int, n: int):
    out = []
    for _ in range(n):
        item, pos = _read(buf, pos)
        out.append(item)
    return out, pos


def _ext(buf: memoryview, pos: int, n: int):
    code, pos = _take(buf, pos, 1)
    code = struct.unpack(">b", code)[0]
    payload, pos = _take(buf, pos, n)
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack: unsupported ext type {code}")
    leaf = unpackb(payload)
    if not (isinstance(leaf, list) and len(leaf) == 3
            and isinstance(leaf[0], list) and isinstance(leaf[1], str)
            and isinstance(leaf[2], bytes)):
        raise ValueError("msgpack: ndarray ext is not (shape, dtype, "
                         "bytes)")
    shape, dtype, raw = leaf
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return arr.copy(), pos
