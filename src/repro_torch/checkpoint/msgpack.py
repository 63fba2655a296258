"""The subset of MessagePack the checkpoint format uses, in plain Python.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes
for maps (dict, in insertion order), str, bytes (bin), int of every
width, float (float64), bool, None and arrays (list, tuple), each in the
smallest encoding that holds it, so a checkpoint the port saves is byte
for byte the reference's. ``unpackb`` reads those types back (str keys
and values as ``str``, bin as ``bytes``, arrays as lists), plus float32;
anything else raises ``ValueError``. ``map_header`` and ``bin_header``
write the heads of a map and a bin alone, and ``StreamReader`` reads
from a source of bytes in order, so a checkpoint streams one entry at a
time both ways.
"""
from __future__ import annotations

import struct

import numpy as np


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fixed form below ``fix_max``, else the
    narrowest of ``codes`` = (8-bit or None, 16-bit, 32-bit) codes."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"object of length {n} is too long for msgpack")


def _int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if x < top:
                out += struct.pack(fmt, code, x)
                return
        raise ValueError(f"int {x} is too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)),
                               (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if x >= low:
                out += struct.pack(fmt, code, x)
                return
        raise ValueError(f"int {x} is too small for msgpack")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False or isinstance(obj, np.bool_):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        _int(out, int(obj))
    elif isinstance(obj, (float, np.floating)):
        out += struct.pack(">Bd", 0xCB, float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += bin_header(len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        out += map_header(len(obj))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise ValueError(f"cannot pack {type(obj).__name__}")


def map_header(n: int) -> bytes:
    """The head of a map of ``n`` pairs (its pairs follow it)."""
    out = bytearray()
    _head(out, n, 0x80, 16, (None, 0xDE, 0xDF))
    return bytes(out)


def bin_header(n: int) -> bytes:
    """The head of a bin of ``n`` bytes (its bytes follow it)."""
    out = bytearray()
    _head(out, n, None, 0, (0xC4, 0xC5, 0xC6))
    return bytes(out)


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)`` for the types above)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.num(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return self.map(b & 0x0F)
        if b & 0xF0 == 0x90:
            return [self.obj() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return self.take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.num(nums[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b not in sizes:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.num(sizes[b])
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map_len(self) -> int:
        """The length of the map whose head comes next."""
        b = self.num(">B")
        if b & 0xF0 == 0x80:
            return b & 0x0F
        if b in (0xDE, 0xDF):
            return self.num(">H" if b == 0xDE else ">I")
        raise ValueError(f"msgpack type byte 0x{b:02x} is not a map's")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


class StreamReader(_Reader):
    """A ``_Reader`` over a source: ``take(n)`` gives its next ``n``
    bytes (a bin comes back as that, a ``bytearray``)."""

    def __init__(self, take):
        self.take = take


def unpackb(buf: bytes):
    """The object one MessagePack blob holds (see the module docstring
    for the types read)."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return out
