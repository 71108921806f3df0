"""Reader and writer for flax's checkpoint format
(``flax.serialization.to_bytes``), in pure Python: the port needs neither
flax nor msgpack.

The file is a nested msgpack map of ``str`` to ext type 1; the ext payload
is itself msgpack, the tuple ``(shape, dtype name, raw C-order bytes)`` of
one numpy array. The reader knows the msgpack types such a file uses (maps,
strings, binary, short arrays, unsigned ints, ext) and raises ``ValueError``
on anything else. ``dump`` writes a tree of str-keyed dicts of numpy arrays
with the encodings msgpack-python chooses (the shortest of each kind), so
``flax.serialization.from_bytes`` and ``load`` both read it.
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


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _pack_len(n: int, fix_base: int | None, fix_max: int, codes) -> bytes:
    """The header of a sized item: the fix form when n <= fix_max, else the
    first of ``codes`` ((byte, field size) pairs) whose field holds n."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, size in codes:
        if n < 1 << (8 * size):
            return bytes([code]) + struct.pack(_UINT[size], n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"msgpack: negative int {n}")
    if n <= 0x7f:
        return bytes([n])
    return _pack_len(n, None, -1, ((0xcc, 1), (0xcd, 2), (0xce, 4)))


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _pack_len(len(raw), 0xa0, 31,
                     ((0xd9, 1), (0xda, 2), (0xdb, 4))) + raw


def _pack_bin(b: bytes) -> bytes:
    return _pack_len(len(b), None, -1, ((0xc4, 1), (0xc5, 2), (0xc6, 4))) + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fix = {v: k for k, v in _FIXEXT.items()}
    head = (bytes([fix[n]]) if n in fix else
            _pack_len(n, None, -1, ((0xc7, 1), (0xc8, 2), (0xc9, 4))))
    return head + struct.pack(">b", code) + payload


def _pack(obj) -> bytes:
    if isinstance(obj, dict):
        out = [_pack_len(len(obj), 0x80, 15, ((0xde, 2), (0xdf, 4)))]
        for key, value in obj.items():
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a string")
            out.append(_pack_str(key))
            out.append(_pack(value))
        return b"".join(out)
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        leaf = [_pack_len(3, 0x90, 15, ())]
        leaf.append(_pack_len(arr.ndim, 0x90, 15, ((0xdc, 2),)))
        leaf += [_pack_uint(int(d)) for d in arr.shape]
        leaf.append(_pack_str(arr.dtype.name))
        leaf.append(_pack_bin(arr.tobytes()))
        return _pack_ext(_EXT_NDARRAY, b"".join(leaf))
    raise ValueError(f"msgpack: cannot write {type(obj).__name__}")


def dump(tree: dict) -> bytes:
    """Encode a nested dict of str -> (dict | numpy array) as flax's
    ``to_bytes`` does: each array an ext of type 1 holding the msgpack of
    (shape, dtype name, C-order bytes)."""
    if not isinstance(tree, dict):
        raise ValueError("msgpack: a checkpoint is a dict")
    return _pack(tree)
