"""MessagePack encoding of snapshot headers, metadata blobs and WAL records.

A stdlib-only codec for the subset of MessagePack this repo writes: nil,
bool, int (up to 64 bits), float, str, bin, array and map. ``packb``
emits exactly the bytes ``msgpack.packb(obj, use_bin_type=True)`` emits
(smallest width for every int, float64 for floats, str8 for short
strings), so snapshots and records written by either load with either.
``unpackb`` also reads float32 and any valid width of the other types;
extension types are refused.

The decoder returns ``str`` for str, ``bytes`` for bin, ``list`` for
array and ``dict`` for map (map keys may be any hashable decoded value,
like ``msgpack.unpackb(..., raw=False, strict_map_key=False)``).
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def packb(obj) -> bytes:
    """Encode ``obj`` (None, bool, int, float, str, bytes-like, list,
    tuple, dict, nested) as MessagePack bytes."""
    out: list = []
    _pack(obj, out.append)
    return b"".join(out)


def _pack_len(n: int, fix_tag: int, fix_max: int, tags, put) -> None:
    """Header of a str/bin/array/map of length ``n``: a fix form when
    ``fix_tag`` is given and ``n <= fix_max``, else the 8/16/32-bit form
    (``tags`` = (tag8 or None, tag16, tag32))."""
    t8, t16, t32 = tags
    if fix_tag is not None and n <= fix_max:
        put(_B.pack(fix_tag | n))
    elif t8 is not None and n <= 0xFF:
        put(bytes((t8, n)))
    elif n <= 0xFFFF:
        put(bytes((t16,)) + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        put(bytes((t32,)) + _I.pack(n))
    else:
        raise ValueError(f"object of length {n} is too large to encode")


_BYTE = [bytes((i,)) for i in range(256)]  # one-byte headers and fixints


def _pack(obj, put) -> None:
    t = type(obj)
    # exact-type fast paths for what metadata blobs are made of
    if t is str:
        raw = obj.encode("utf-8")
        if len(raw) <= 31:
            put(_BYTE[0xA0 | len(raw)] + raw)
        else:
            _pack_len(len(raw), None, 0, (0xD9, 0xDA, 0xDB), put)
            put(raw)
    elif t is int:
        if 0 <= obj <= 0x7F:
            put(_BYTE[obj])
        else:
            _pack_int(obj, put)
    elif t is dict:
        n = len(obj)
        if n <= 15:
            put(_BYTE[0x80 | n])
        else:
            _pack_len(n, None, 0, (None, 0xDE, 0xDF), put)
        for key, value in obj.items():
            _pack(key, put)
            _pack(value, put)
    elif t is list or t is tuple:
        n = len(obj)
        if n <= 15:
            put(_BYTE[0x90 | n])
        else:
            _pack_len(n, None, 0, (None, 0xDC, 0xDD), put)
        for item in obj:
            _pack(item, put)
    elif obj is None:
        put(b"\xc0")
    elif obj is True:
        put(b"\xc3")
    elif obj is False:
        put(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), put)
    elif isinstance(obj, float):
        put(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        _pack(str(obj), put)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), put)
        put(raw)
    elif isinstance(obj, (list, tuple)):
        _pack(list(obj), put)
    elif isinstance(obj, dict):
        _pack(dict(obj), put)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(v: int, put) -> None:
    if v >= 0:
        if v <= 0x7F:
            put(_B.pack(v))
        elif v <= 0xFF:
            put(b"\xcc" + _B.pack(v))
        elif v <= 0xFFFF:
            put(b"\xcd" + _H.pack(v))
        elif v <= 0xFFFFFFFF:
            put(b"\xce" + _I.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            put(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError("int too big to encode")
    elif v >= -32:
        put(_b.pack(v))
    elif v >= -0x80:
        put(b"\xd0" + _b.pack(v))
    elif v >= -0x8000:
        put(b"\xd1" + _h.pack(v))
    elif v >= -0x80000000:
        put(b"\xd2" + _i.pack(v))
    elif v >= -0x8000000000000000:
        put(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError("int too big to encode")


def unpackb(data) -> object:
    """Decode one MessagePack object that spans all of ``data``."""
    buf = memoryview(data).cast("B") if not isinstance(data, bytes) else data
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"extra data after the object: {len(buf) - pos} bytes")
    return obj


# fixed-width scalars: tag -> (struct, size)
_SCALARS = {
    0xCA: (_f, 4), 0xCB: (_d, 8),
    0xCC: (_B, 1), 0xCD: (_H, 2), 0xCE: (_I, 4), 0xCF: (_Q, 8),
    0xD0: (_b, 1), 0xD1: (_h, 2), 0xD2: (_i, 4), 0xD3: (_q, 8),
}
# sized containers: tag -> (kind, length struct, length size)
_SIZED = {
    0xD9: ("str", _B, 1), 0xDA: ("str", _H, 2), 0xDB: ("str", _I, 4),
    0xC4: ("bin", _B, 1), 0xC5: ("bin", _H, 2), 0xC6: ("bin", _I, 4),
    0xDC: ("array", _H, 2), 0xDD: ("array", _I, 4),
    0xDE: ("map", _H, 2), 0xDF: ("map", _I, 4),
}


def _take(buf, pos: int, n: int) -> int:
    end = pos + n
    if end > len(buf):
        raise ValueError("truncated MessagePack data")
    return end


def _unpack(buf, pos: int):
    try:
        tag = buf[pos]
    except IndexError:
        raise ValueError("truncated MessagePack data") from None
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if tag >= 0xA0 and tag <= 0xBF:  # fixstr: the common metadata case
        end = pos + (tag & 0x1F)
        if end > len(buf):
            raise ValueError("truncated MessagePack data")
        return bytes(buf[pos:end]).decode("utf-8"), end
    if tag >= 0x80 and tag <= 0x8F:
        return _container(buf, pos, "map", tag & 0x0F)
    if tag >= 0x90 and tag <= 0x9F:
        return _container(buf, pos, "array", tag & 0x0F)
    if tag == 0xC0:
        return None, pos
    if tag == 0xC2:
        return False, pos
    if tag == 0xC3:
        return True, pos
    scalar = _SCALARS.get(tag)
    if scalar is not None:
        st, size = scalar
        end = _take(buf, pos, size)
        return st.unpack_from(buf, pos)[0], end
    sized = _SIZED.get(tag)
    if sized is not None:
        kind, st, size = sized
        end = _take(buf, pos, size)
        return _container(buf, end, kind, st.unpack_from(buf, pos)[0])
    raise ValueError(f"unsupported MessagePack type byte 0x{tag:02x}")


def _container(buf, pos: int, kind: str, n: int):
    if kind == "str":
        end = _take(buf, pos, n)
        return bytes(buf[pos:end]).decode("utf-8"), end
    if kind == "bin":
        end = _take(buf, pos, n)
        return bytes(buf[pos:end]), end
    if kind == "array":
        items = [None] * n
        for j in range(n):
            items[j], pos = _unpack(buf, pos)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        if isinstance(key, list):
            raise ValueError("array map keys are not supported")
        out[key], pos = _unpack(buf, pos)
    return out, pos
