"""mcpack v2 binary codec + protobuf bridge (the mcpack2pb equivalent).

Reference behavior: src/mcpack2pb/ — field heads (field_type.h:30-76,
parser.cpp:25-80): FieldFixedHead(u8 type, u8 name_size) for primitives
whose size is the type's low nibble; FieldShortHead(+u8 value_size) for
strings ≤254 and binary ≤255 with FIELD_SHORT_MASK set on the type;
FieldLongHead(+u32le value_size) otherwise.  Names are NUL-terminated and
name_size counts the NUL (0 = unnamed, e.g. array items and the top-level
object).  OBJECT/ARRAY values start with ItemsHead(u32le item_count);
ISOARRAY values start with IsoItemsHead(u8 item type) and then raw
unheaded items.  Strings carry a trailing NUL in their value.

The reference generates per-message C++ codecs (generator.cpp); here the
bridge walks protobuf descriptors at runtime — same wire, no codegen.
Python values map: dict→OBJECT, list→ARRAY, str→STRING, bytes→BINARY,
bool→BOOL, int→smallest signed/unsigned fit, float→DOUBLE, None→NULL.
compack (the reference's FORMAT_COMPACK, selectable via
SerializationFormat) shares these field heads; its only wire difference
is that homogeneous primitive arrays are serialized as ISOARRAYs
(mcpack2pb/serializer.cpp:716-740) — pass compack=True to mcpack_encode/
pb_to_mcpack for that variant (used by the ubrpc_compack protocol).

The bytes it writes and reads are those of the JAX package's
``codec/mcpack.py``.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

FIELD_OBJECT = 0x10
FIELD_ARRAY = 0x20
FIELD_ISOARRAY = 0x30
FIELD_OBJECTISOARRAY = 0x40
FIELD_STRING = 0x50
FIELD_BINARY = 0x60
FIELD_INT8 = 0x11
FIELD_INT16 = 0x12
FIELD_INT32 = 0x14
FIELD_INT64 = 0x18
FIELD_UINT8 = 0x21
FIELD_UINT16 = 0x22
FIELD_UINT32 = 0x24
FIELD_UINT64 = 0x28
FIELD_BOOL = 0x31
FIELD_FLOAT = 0x44
FIELD_DOUBLE = 0x48
FIELD_NULL = 0x61

FIELD_SHORT_MASK = 0x80
FIELD_FIXED_MASK = 0x0F

_INT_PACK = {
    FIELD_INT8: "<b", FIELD_INT16: "<h", FIELD_INT32: "<i",
    FIELD_INT64: "<q", FIELD_UINT8: "<B", FIELD_UINT16: "<H",
    FIELD_UINT32: "<I", FIELD_UINT64: "<Q",
}


class McpackError(ValueError):
    pass


# ---- encoding ---------------------------------------------------------

def _name_bytes(name: str) -> bytes:
    if not name:
        return b""
    nb = name.encode() + b"\x00"
    if len(nb) > 255:
        raise McpackError(f"field name too long: {name[:32]}...")
    return nb


def _fixed(out: bytearray, ftype: int, name: str, value: bytes) -> None:
    nb = _name_bytes(name)
    out += struct.pack("<BB", ftype, len(nb))
    out += nb
    out += value


def _short_or_long(out: bytearray, ftype: int, name: str,
                   value: bytes) -> None:
    nb = _name_bytes(name)
    if len(value) <= 255:
        out += struct.pack("<BBB", ftype | FIELD_SHORT_MASK, len(nb),
                           len(value))
    else:
        out += struct.pack("<BBI", ftype, len(nb), len(value))
    out += nb
    out += value


def _pick_int_type(v: int) -> int:
    if v < 0:
        if v >= -(1 << 7):
            return FIELD_INT8
        if v >= -(1 << 15):
            return FIELD_INT16
        if v >= -(1 << 31):
            return FIELD_INT32
        if v >= -(1 << 63):
            return FIELD_INT64
        raise McpackError(f"int out of range: {v}")
    if v < (1 << 7):
        return FIELD_INT8
    if v < (1 << 15):
        return FIELD_INT16
    if v < (1 << 31):
        return FIELD_INT32
    if v < (1 << 63):
        return FIELD_INT64
    if v < (1 << 64):
        return FIELD_UINT64
    raise McpackError(f"int out of range: {v}")


def _iso_item_type(value: List[Any]) -> Tuple[int, str, int]:
    """Uniform primitive item (type, pack fmt, size) for a compack
    isoarray, or (0, "", 0) when the list is not isoarray-eligible."""
    if not value:
        return 0, "", 0
    if all(isinstance(v, bool) for v in value):
        return FIELD_BOOL, "", 1
    if all(isinstance(v, int) and not isinstance(v, bool) for v in value):
        lo, hi = _pick_int_type(min(value)), _pick_int_type(max(value))
        if FIELD_UINT64 in (lo, hi):
            if min(value) < 0:
                return 0, "", 0           # mixed sign beyond int64: bail
            t = FIELD_UINT64
        else:
            t = lo if (lo & FIELD_FIXED_MASK) >= (hi & FIELD_FIXED_MASK) \
                else hi
        return t, _INT_PACK[t], t & FIELD_FIXED_MASK
    if all(isinstance(v, float) for v in value):
        return FIELD_DOUBLE, "<d", 8
    return 0, "", 0


def _encode_field(out: bytearray, name: str, value: Any,
                  compack: bool = False) -> None:
    if value is None:
        _fixed(out, FIELD_NULL, name, b"\x00")
    elif isinstance(value, bool):
        _fixed(out, FIELD_BOOL, name, b"\x01" if value else b"\x00")
    elif isinstance(value, int):
        t = _pick_int_type(value)
        _fixed(out, t, name, struct.pack(_INT_PACK[t], value))
    elif isinstance(value, float):
        _fixed(out, FIELD_DOUBLE, name, struct.pack("<d", value))
    elif isinstance(value, str):
        _short_or_long(out, FIELD_STRING, name, value.encode() + b"\x00")
    elif isinstance(value, (bytes, bytearray, memoryview)):
        _short_or_long(out, FIELD_BINARY, name, bytes(value))
    elif isinstance(value, dict):
        _encode_group(out, FIELD_OBJECT, name,
                      [(k, v) for k, v in value.items()], compack)
    elif isinstance(value, (list, tuple)):
        # FORMAT_COMPACK (mcpack2pb/serializer.cpp:716-740): primitive
        # arrays carry one item-type byte + raw values, no per-item heads
        if compack:
            t, fmt, isize = _iso_item_type(list(value))
            if t:
                body = bytearray([t])
                for v in value:
                    body += (b"\x01" if v else b"\x00") if t == FIELD_BOOL \
                        else struct.pack(fmt, v)
                _short_or_long(out, FIELD_ISOARRAY, name, bytes(body))
                return
        _encode_group(out, FIELD_ARRAY, name, [("", v) for v in value],
                      compack)
    else:
        raise McpackError(f"cannot mcpack-encode {type(value).__name__}")


def _encode_group(out: bytearray, ftype: int, name: str,
                  items: List[Tuple[str, Any]],
                  compack: bool = False) -> None:
    body = bytearray(struct.pack("<I", len(items)))
    for n, v in items:
        _encode_field(body, n, v, compack)
    nb = _name_bytes(name)
    out += struct.pack("<BBI", ftype, len(nb), len(body))
    out += nb
    out += body


def mcpack_encode(obj: Dict[str, Any], compack: bool = False) -> bytes:
    """Serialize a dict as a top-level (unnamed) object.  With
    compack=True, emit the reference's FORMAT_COMPACK variant
    (mcpack2pb.h:41): identical field heads, but homogeneous primitive
    arrays become ISOARRAYs."""
    if not isinstance(obj, dict):
        raise McpackError("top-level mcpack value must be a dict")
    out = bytearray()
    _encode_group(out, FIELD_OBJECT, "", list(obj.items()), compack)
    return bytes(out)


# ---- decoding ---------------------------------------------------------

class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise McpackError("truncated mcpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]


def _decode_field(r: _Reader) -> Tuple[str, Any]:
    ftype = r.u8()
    name_size = r.u8()
    if ftype & FIELD_SHORT_MASK:
        base = ftype & ~FIELD_SHORT_MASK
        value_size = r.u8()
    elif ftype & FIELD_FIXED_MASK:
        base = ftype
        value_size = ftype & FIELD_FIXED_MASK
    else:
        base = ftype
        value_size = struct.unpack("<I", r.take(4))[0]
    name = r.take(name_size)[:-1].decode() if name_size else ""
    if base == FIELD_NULL:
        r.take(1)
        return name, None
    if base == FIELD_BOOL:
        return name, r.take(1) != b"\x00"
    if base in _INT_PACK:
        return name, struct.unpack(_INT_PACK[base], r.take(value_size))[0]
    if base == FIELD_FLOAT:
        return name, struct.unpack("<f", r.take(4))[0]
    if base == FIELD_DOUBLE:
        return name, struct.unpack("<d", r.take(8))[0]
    if base == FIELD_STRING:
        raw = r.take(value_size)
        return name, raw[:-1].decode() if raw else ""
    if base == FIELD_BINARY:
        return name, r.take(value_size)
    if base in (FIELD_OBJECT, FIELD_ARRAY):
        end = r.pos + value_size
        count = struct.unpack("<I", r.take(4))[0]
        if base == FIELD_OBJECT:
            obj: Dict[str, Any] = {}
            for _ in range(count):
                k, v = _decode_field(r)
                obj[k] = v
            val: Any = obj
        else:
            val = [_decode_field(r)[1] for _ in range(count)]
        if r.pos != end:
            raise McpackError(f"group size mismatch: at {r.pos}, want {end}")
        return name, val
    if base == FIELD_ISOARRAY:
        end = r.pos + value_size
        item_type = r.u8()
        fmt = _INT_PACK.get(item_type)
        if item_type == FIELD_DOUBLE:
            fmt, isize = "<d", 8
        elif item_type == FIELD_FLOAT:
            fmt, isize = "<f", 4
        elif item_type == FIELD_BOOL:
            fmt, isize = None, 1
        elif fmt is not None:
            isize = item_type & FIELD_FIXED_MASK
        else:
            raise McpackError(f"bad isoarray item type {item_type:#x}")
        nbytes = end - r.pos
        if nbytes % isize:
            raise McpackError("isoarray size not a multiple of item size")
        items: List[Any] = []
        for _ in range(nbytes // isize):
            raw = r.take(isize)
            items.append(raw != b"\x00" if fmt is None
                         else struct.unpack(fmt, raw)[0])
        return name, items
    raise McpackError(f"unknown mcpack field type {ftype:#x}")


def mcpack_decode(data: bytes) -> Dict[str, Any]:
    """Parse a top-level mcpack_v2 object into a dict."""
    r = _Reader(data)
    name, value = _decode_field(r)
    if not isinstance(value, dict):
        raise McpackError("top-level mcpack value is not an object")
    return value


def mcpack_decode_prefix(data: bytes) -> Tuple[Dict[str, Any], int]:
    """Parse one top-level object, returning (object, bytes consumed)."""
    r = _Reader(data)
    _, value = _decode_field(r)
    if not isinstance(value, dict):
        raise McpackError("top-level mcpack value is not an object")
    return value, r.pos


# ---- protobuf bridge (mcpack2pb) --------------------------------------

def _is_repeated(fd) -> bool:
    rep = getattr(fd, "is_repeated", None)
    if isinstance(rep, bool):
        return rep
    from google.protobuf.descriptor import FieldDescriptor as FD
    return fd.label == FD.LABEL_REPEATED


def _is_map(fd) -> bool:
    mt = getattr(fd, "message_type", None)
    return mt is not None and mt.GetOptions().map_entry


def pb_to_dict(msg: Any) -> Dict[str, Any]:
    """Walk the descriptor: the mcpack field names are the pb field names
    (what the reference's generated code emits)."""
    from google.protobuf.descriptor import FieldDescriptor as FD
    out: Dict[str, Any] = {}
    for fd, value in msg.ListFields():
        if _is_map(fd):
            vfd = fd.message_type.fields_by_name["value"]
            if vfd.type == FD.TYPE_MESSAGE:
                out[fd.name] = {str(k): pb_to_dict(v)
                                for k, v in value.items()}
            else:
                out[fd.name] = {str(k): v for k, v in value.items()}
        elif _is_repeated(fd):
            if fd.type == FD.TYPE_MESSAGE:
                out[fd.name] = [pb_to_dict(m) for m in value]
            else:
                out[fd.name] = list(value)
        elif fd.type == FD.TYPE_MESSAGE:
            out[fd.name] = pb_to_dict(value)
        else:
            out[fd.name] = value
    return out


def dict_to_pb(d: Dict[str, Any], msg: Any) -> Any:
    from google.protobuf.descriptor import FieldDescriptor as FD
    for fd in msg.DESCRIPTOR.fields:
        if fd.name not in d:
            continue
        value = d[fd.name]
        if _is_map(fd):
            target = getattr(msg, fd.name)
            vfd = fd.message_type.fields_by_name["value"]
            kfd = fd.message_type.fields_by_name["key"]
            for k, v in value.items():
                key = int(k) if kfd.type != FD.TYPE_STRING and \
                    isinstance(k, str) else k
                if vfd.type == FD.TYPE_MESSAGE:
                    dict_to_pb(v, target[key])
                else:
                    target[key] = v
        elif _is_repeated(fd):
            target = getattr(msg, fd.name)
            for item in value:
                if fd.type == FD.TYPE_MESSAGE:
                    dict_to_pb(item, target.add())
                else:
                    target.append(item)
        elif fd.type == FD.TYPE_MESSAGE:
            dict_to_pb(value, getattr(msg, fd.name))
        elif fd.type == FD.TYPE_BYTES:
            setattr(msg, fd.name, bytes(value))
        else:
            setattr(msg, fd.name, value)
    return msg


def pb_to_mcpack(msg: Any, compack: bool = False) -> bytes:
    return mcpack_encode(pb_to_dict(msg), compack=compack)


def mcpack_to_pb(data: bytes, msg: Any) -> Any:
    return dict_to_pb(mcpack_decode(data), msg)
