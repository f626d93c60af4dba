"""A msgpack codec for the subset a checkpoint manifest uses.

Maps, arrays, str, int (from -2^63 to 2^64 - 1), float, bool and nil.
:func:`packb` writes what ``msgpack.packb`` writes for
these objects with its defaults: the smallest encoding of each int, ``0xcb``
(float64) for every float, str as UTF-8 ``str`` (not ``bin``), tuples as
arrays.  :func:`unpackb` reads that subset back (maps to dicts, arrays to
lists, str to str).  The port needs no ``msgpack`` package.
"""
from __future__ import annotations

import struct


class MsgpackError(ValueError):
    """An object outside the manifest subset, or bytes that are not it."""


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 1 << 8:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 1 << 16:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 1 << 32:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise MsgpackError(f"int {v} does not fit in 64 bits")
    elif v >= -32:
        out += struct.pack(">b", v)
    elif v >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -(1 << 63):
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise MsgpackError(f"int {v} does not fit in 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32 bits
    (``codes`` names the wider forms; ``None`` where the type has none)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit in 32 bits")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    else:
        raise MsgpackError(f"cannot serialize {type(obj).__name__} into a manifest")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (see the module docstring for the subset)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def seq(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def read(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.seq(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
                 0xDF: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xDB:
                return self.text(n)
            return self.seq(n) if b <= 0xDD else self.mapping(n)
        raise MsgpackError(f"msgpack type byte 0x{b:02x} is outside the manifest subset")


def unpackb(data: bytes):
    """The object ``data`` holds (maps as dicts, arrays as lists)."""
    reader = _Reader(bytes(data))
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} trailing bytes after the object")
    return obj
