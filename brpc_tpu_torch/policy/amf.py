"""AMF0 codec — Action Message Format, the RTMP command/metadata encoding
(port of :mod:`brpc_tpu.policy.amf`; the bytes are the same).

Reference: src/brpc/amf.{h,cpp} (AMFObject/AMFField at amf.h:40-170,
ReadAMFObject/WriteAMFObject).  The reference models AMF values with a
dedicated AMFObject class tree; here values map to native Python types
(float/bool/str/dict/list/None) plus three thin wrappers for markers that
have no native analogue: :class:`Undefined`, :class:`EcmaArray`,
:class:`AmfDate`.  Dicts preserve insertion order, matching the field
order the reference keeps in its vector-backed AMFObject.

Only AMF0 is implemented; AMF3 appears on the RTMP wire solely as the
0x11 command-message envelope whose body is AMF0 after a one-byte format
selector (handled in policy/rtmp.py), mirroring the reference's support
surface (rtmp_protocol.cpp treats AMF3 commands the same way).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# AMF0 type markers (amf.h:28-46 AMFMarker)
MARKER_NUMBER = 0x00
MARKER_BOOLEAN = 0x01
MARKER_STRING = 0x02
MARKER_OBJECT = 0x03
MARKER_MOVIECLIP = 0x04
MARKER_NULL = 0x05
MARKER_UNDEFINED = 0x06
MARKER_REFERENCE = 0x07
MARKER_ECMA_ARRAY = 0x08
MARKER_OBJECT_END = 0x09
MARKER_STRICT_ARRAY = 0x0A
MARKER_DATE = 0x0B
MARKER_LONG_STRING = 0x0C
MARKER_UNSUPPORTED = 0x0D
MARKER_XML_DOCUMENT = 0x0F
MARKER_TYPED_OBJECT = 0x10
MARKER_AVMPLUS_OBJECT = 0x11


class Undefined:
    """AMF0 'undefined' (distinct from null)."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "amf.UNDEFINED"


UNDEFINED = Undefined()


class EcmaArray(dict):
    """Associative array (marker 0x08): a dict that remembers it should be
    written with the ECMA-array marker rather than the object marker."""


class AmfDate:
    __slots__ = ("epoch_ms", "tz_minutes")

    def __init__(self, epoch_ms: float, tz_minutes: int = 0):
        self.epoch_ms = float(epoch_ms)
        self.tz_minutes = tz_minutes

    def __eq__(self, other):
        return (isinstance(other, AmfDate)
                and other.epoch_ms == self.epoch_ms
                and other.tz_minutes == self.tz_minutes)

    def __repr__(self):
        return f"AmfDate({self.epoch_ms}, tz={self.tz_minutes})"


class AmfError(ValueError):
    pass


# ---- encoding ----------------------------------------------------------

def _enc_utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise AmfError("AMF0 short string over 65535 bytes")
    return struct.pack(">H", len(b)) + b


def _enc_props(out: List[bytes], d: Dict[str, Any]) -> None:
    for k, v in d.items():
        out.append(_enc_utf8(str(k)))
        _encode_value(out, v)
    out.append(b"\x00\x00" + bytes([MARKER_OBJECT_END]))


def _encode_value(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(bytes([MARKER_NULL]))
    elif v is UNDEFINED or isinstance(v, Undefined):
        out.append(bytes([MARKER_UNDEFINED]))
    elif isinstance(v, bool):
        out.append(bytes([MARKER_BOOLEAN, 1 if v else 0]))
    elif isinstance(v, (int, float)):
        out.append(bytes([MARKER_NUMBER]) + struct.pack(">d", float(v)))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        if len(b) > 0xFFFF:
            out.append(bytes([MARKER_LONG_STRING])
                       + struct.pack(">I", len(b)) + b)
        else:
            out.append(bytes([MARKER_STRING]) + _enc_utf8(v))
    elif isinstance(v, AmfDate):
        out.append(bytes([MARKER_DATE])
                   + struct.pack(">dh", v.epoch_ms, v.tz_minutes))
    elif isinstance(v, EcmaArray):
        out.append(bytes([MARKER_ECMA_ARRAY]) + struct.pack(">I", len(v)))
        _enc_props(out, v)
    elif isinstance(v, dict):
        out.append(bytes([MARKER_OBJECT]))
        _enc_props(out, v)
    elif isinstance(v, (list, tuple)):
        out.append(bytes([MARKER_STRICT_ARRAY]) + struct.pack(">I", len(v)))
        for item in v:
            _encode_value(out, item)
    else:
        raise AmfError(f"cannot encode {type(v).__name__} as AMF0")


def encode(*values: Any) -> bytes:
    """Encode values back-to-back (an RTMP command body is a sequence of
    AMF0 values, not a single root)."""
    out: List[bytes] = []
    for v in values:
        _encode_value(out, v)
    return b"".join(out)


# ---- decoding ----------------------------------------------------------

def _dec_utf8(data: bytes, off: int) -> Tuple[str, int]:
    if off + 2 > len(data):
        raise AmfError("truncated string length")
    n = struct.unpack_from(">H", data, off)[0]
    off += 2
    if off + n > len(data):
        raise AmfError("truncated string body")
    return data[off:off + n].decode("utf-8", "replace"), off + n


def _dec_props(data: bytes, off: int, d: Dict[str, Any]) -> int:
    while True:
        key, off = _dec_utf8(data, off)
        if off >= len(data):
            raise AmfError("truncated object")
        if key == "" and data[off] == MARKER_OBJECT_END:
            return off + 1
        val, off = _decode_value(data, off)
        d[key] = val


def _decode_value(data: bytes, off: int) -> Tuple[Any, int]:
    if off >= len(data):
        raise AmfError("truncated value")
    marker = data[off]
    off += 1
    if marker == MARKER_NUMBER:
        if off + 8 > len(data):
            raise AmfError("truncated number")
        return struct.unpack_from(">d", data, off)[0], off + 8
    if marker == MARKER_BOOLEAN:
        if off >= len(data):
            raise AmfError("truncated boolean")
        return data[off] != 0, off + 1
    if marker == MARKER_STRING:
        return _dec_utf8(data, off)
    if marker in (MARKER_OBJECT, MARKER_TYPED_OBJECT):
        d: Dict[str, Any] = {}
        if marker == MARKER_TYPED_OBJECT:       # class name, then props
            _, off = _dec_utf8(data, off)
        off = _dec_props(data, off, d)
        return d, off
    if marker == MARKER_NULL:
        return None, off
    if marker in (MARKER_UNDEFINED, MARKER_UNSUPPORTED):
        return UNDEFINED, off
    if marker == MARKER_ECMA_ARRAY:
        if off + 4 > len(data):
            raise AmfError("truncated ecma array")
        off += 4                                # count is advisory
        arr = EcmaArray()
        off = _dec_props(data, off, arr)
        return arr, off
    if marker == MARKER_STRICT_ARRAY:
        if off + 4 > len(data):
            raise AmfError("truncated strict array")
        n = struct.unpack_from(">I", data, off)[0]
        off += 4
        items = []
        for _ in range(n):
            v, off = _decode_value(data, off)
            items.append(v)
        return items, off
    if marker == MARKER_DATE:
        if off + 10 > len(data):
            raise AmfError("truncated date")
        ms, tz = struct.unpack_from(">dh", data, off)
        return AmfDate(ms, tz), off + 10
    if marker in (MARKER_LONG_STRING, MARKER_XML_DOCUMENT):
        if off + 4 > len(data):
            raise AmfError("truncated long string")
        n = struct.unpack_from(">I", data, off)[0]
        off += 4
        if off + n > len(data):
            raise AmfError("truncated long string body")
        return data[off:off + n].decode("utf-8", "replace"), off + n
    raise AmfError(f"unsupported AMF0 marker 0x{marker:02x}")


def decode(data: bytes, offset: int = 0) -> Tuple[Any, int]:
    """Decode one value; returns (value, next_offset)."""
    return _decode_value(data, offset)


def decode_all(data: bytes) -> List[Any]:
    """Decode back-to-back values until the buffer is exhausted."""
    out = []
    off = 0
    while off < len(data):
        v, off = _decode_value(data, off)
        out.append(v)
    return out
