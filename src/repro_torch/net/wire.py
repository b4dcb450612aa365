"""The overlay's wire codec: a small MessagePack encoder and decoder.

``packb(obj)`` writes the bytes ``msgpack.packb(obj, use_bin_type=True)``
writes and ``unpackb(data)`` reads them back as ``msgpack.unpackb(data,
raw=False)`` does, for the types the overlay sends: dict, list and tuple,
str, bytes (and bytearray, memoryview), int, float, bool and None.  It is
the counterpart of ``repro/overlay/user_node.py`` ``_encode`` /
``_decode``, and byte-identical to them because the simulation depends on
it: ``SimNet`` delays a message by its size, and the overlay sizes its
``kv_pages`` chunks and counts ``kv_wire_bytes`` from the encoded length.

As in msgpack: an int takes the smallest form that holds it (unsigned
forms for non-negative values), a float is always a float64, str is UTF-8
with the str8 form enabled, tuples decode as lists, map keys must decode
as str or bytes, and any other type (a numpy scalar, a tensor) raises
``TypeError`` instead of being converted.
"""
from __future__ import annotations

import struct


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple):
    """Length header: fixed form under ``fix_max``, else the 8- (if any),
    16- or 32-bit form from ``codes``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"length {n} too large for msgpack")


def _int(out: bytearray, x: int):
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x > 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if x < 1 << (8 * width):
                out.append(code)
                out += x.to_bytes(width, "big")
                return
        raise OverflowError("int too big to pack")
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if x >= -(1 << (8 * width - 1)):
                out.append(code)
                out += x.to_bytes(width, "big", signed=True)
                return
        raise OverflowError("int too big to pack")


def _pack(out: bytearray, obj):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), 0, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += data
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, ((0xDC, 2), (0xDD, 4)))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    MAX_DEPTH = 256          # nested containers (Python's own stack is the limit)

    def __init__(self, data: bytes):
        self.data = memoryview(bytes(data))
        self.pos = 0
        self.depth = 0

    def take(self, n: int) -> memoryview:
        if n > len(self.data) - self.pos:
            raise ValueError("Unpack failed: incomplete input")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def count(self, n: int, per_item: int = 1) -> int:
        """A container or payload length, no larger than the input could
        hold (as msgpack's ``max_*_len`` defaults bound it)."""
        if n * per_item > len(self.data):
            raise ValueError(f"length {n} exceeds the input's {len(self.data)} bytes")
        return n

    def nest(self):
        self.depth += 1
        if self.depth > self.MAX_DEPTH:
            raise ValueError(f"Unpack failed: nested deeper than {self.MAX_DEPTH}")


def _unpack(r: _Reader):
    b = r.uint(1)
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b < 0x90:
        return _map(r, b & 0x0F)
    if b < 0xA0:
        return _array(r, b & 0x0F)
    if b < 0xC0:
        return _str(r, b & 0x1F)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        n = r.count(r.uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[b]))
        return bytes(r.take(n))
    if b == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if b == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if 0xCC <= b <= 0xCF:
        return r.uint(1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:
        return int.from_bytes(r.take(1 << (b - 0xD0)), "big", signed=True)
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r, r.uint({0xD9: 1, 0xDA: 2, 0xDB: 4}[b]))
    if b in (0xDC, 0xDD):
        return _array(r, r.uint(2 if b == 0xDC else 4))
    if b in (0xDE, 0xDF):
        return _map(r, r.uint(2 if b == 0xDE else 4))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int) -> str:
    return str(r.take(r.count(n)), "utf-8")


def _array(r: _Reader, n: int) -> list:
    r.nest()
    out = [_unpack(r) for _ in range(r.count(n))]
    r.depth -= 1
    return out


def _map(r: _Reader, n: int) -> dict:
    r.nest()
    out = {}
    for _ in range(r.count(n, 2)):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r)
    r.depth -= 1
    return out


def unpackb(data: bytes):
    """The object ``packb`` wrote (``msgpack.unpackb(data, raw=False)``):
    raises ``ValueError`` on truncated, trailing, unknown or too deeply
    nested bytes."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("Unpack failed: extra data after the object")
    return obj
