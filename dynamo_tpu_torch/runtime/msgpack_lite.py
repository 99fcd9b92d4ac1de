"""The subset of MessagePack the serving plane speaks, in the standard library.

`packb(obj)` returns the bytes `msgpack.packb(obj, use_bin_type=True)`
returns, and `unpackb(data)` the value `msgpack.unpackb(data, raw=False)`
returns, for the types the request plane and discovery put on the wire:

  nil, bool, int (the smallest encoding first: positive/negative fixint,
  u8-u64, i8-i64), float (float64, as msgpack packs a Python float), str
  (fixstr, str8, str16, str32), bytes/bytearray/memoryview (bin8/16/32),
  list/tuple (fixarray, array16/32), dict (fixmap, map16/32, in insertion
  order).

A reference peer decodes these frames with the real msgpack, so the bytes,
not only the decoded values, must agree. As in msgpack: an int outside
i64..u64 raises OverflowError, an object of any other type TypeError.
Decoding accepts float32 too; an ext type, a map key that is not str or
bytes, truncated input and trailing bytes raise ValueError.

A long run of floats (an encoder's embedding rows: 602,112 floats a
full-width image part) is packed and unpacked with one `struct` call and
eight strided byte copies instead of one call a float: the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(n: int, out: List[bytes]) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(_B.pack(n))
        elif n <= 0xFF:
            out.append(b"\xcc" + _B.pack(n))
        elif n <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(n))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(_b.pack(n))
    elif n >= -0x80:
        out.append(b"\xd0" + _b.pack(n))
    elif n >= -0x8000:
        out.append(b"\xd1" + _h.pack(n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + _i.pack(n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags: Tuple[bytes, ...],
              out: List[bytes]) -> None:
    """Length header: a fix form below `fix_max`, then 8/16/32-bit forms
    (`tags` lists the tags for the widths the type has, narrowest first)."""
    if n < fix_max:
        out.append(_B.pack(fix_tag | n))
        return
    for tag, st in zip(tags, (_B, _H, _I)[3 - len(tags):]):
        if n <= (1 << (8 * st.size)) - 1:
            out.append(tag + st.pack(n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n <= 0xFF:
            out.append(b"\xc4" + _B.pack(n))
        elif n <= 0xFFFF:
            out.append(b"\xc5" + _H.pack(n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xc6" + _I.pack(n))
        else:
            raise ValueError(f"bin of {n} bytes too large for msgpack")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (b"\xdc", b"\xdd"), out)
        if len(obj) >= FLOAT_RUN and all(type(x) is float for x in obj):
            out.append(_pack_floats(obj))
            return
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


FLOAT_RUN = 16  # a list at least this long, all floats, takes the one-call path


def _pack_floats(xs) -> bytes:
    """float64 elements [0xcb, 8 big-endian bytes] of every float in `xs`."""
    n = len(xs)
    vals = struct.pack(f">{n}d", *xs)
    out = bytearray(9 * n)
    out[0::9] = b"\xcb" * n
    for j in range(8):
        out[1 + j::9] = vals[j::8]
    return bytes(out)


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _str(r: _Reader, n: int) -> str:
    return r.take(n).decode("utf-8")


def _array(r: _Reader, n: int) -> list:
    if n >= FLOAT_RUN:
        body = r.buf[r.pos:r.pos + 9 * n]
        if len(body) == 9 * n and body[0::9] == b"\xcb" * n:  # n float64 elements
            vals = bytearray(8 * n)
            for j in range(8):
                vals[j::8] = body[1 + j::9]
            r.pos += 9 * n
            return list(struct.unpack(f">{n}d", vals))
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if type(k) not in (str, bytes):
            raise ValueError(
                f"{type(k).__name__} is not allowed for map key when strict_map_key=True"
            )
        out[k] = _unpack(r)
    return out


# tag -> reader of the value (or of its length, then its body) for the 0xc0.. tags
_TAGGED = {
    0xCC: lambda r: r.num(_B), 0xCD: lambda r: r.num(_H),
    0xCE: lambda r: r.num(_I), 0xCF: lambda r: r.num(_Q),
    0xD0: lambda r: r.num(_b), 0xD1: lambda r: r.num(_h),
    0xD2: lambda r: r.num(_i), 0xD3: lambda r: r.num(_q),
    0xCA: lambda r: r.num(_f), 0xCB: lambda r: r.num(_d),
    0xD9: lambda r: _str(r, r.num(_B)), 0xDA: lambda r: _str(r, r.num(_H)),
    0xDB: lambda r: _str(r, r.num(_I)),
    0xC4: lambda r: r.take(r.num(_B)), 0xC5: lambda r: r.take(r.num(_H)),
    0xC6: lambda r: r.take(r.num(_I)),
    0xDC: lambda r: _array(r, r.num(_H)), 0xDD: lambda r: _array(r, r.num(_I)),
    0xDE: lambda r: _map(r, r.num(_H)), 0xDF: lambda r: _map(r, r.num(_I)),
}
_CONST = {0xC0: None, 0xC2: False, 0xC3: True}


def _unpack(r: _Reader) -> Any:
    tag = r.take(1)[0]
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag < 0x90:
        return _map(r, tag & 0x0F)
    if tag < 0xA0:
        return _array(r, tag & 0x0F)
    if tag < 0xC0:
        return _str(r, tag & 0x1F)
    if tag in _CONST:
        return _CONST[tag]
    fn = _TAGGED.get(tag)
    if fn is None:  # ext types (0xc7-0xc9, 0xd4-0xd8) and the unused 0xc1
        raise ValueError(f"msgpack tag {tag:#x} is not supported")
    return fn(r)


def unpackb(data) -> Any:
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("unpack(b) received extra data.")
    return obj
