"""Thrift framed-binary protocol (client + server).

Reference: src/brpc/policy/thrift_protocol.cpp + thrift_message.{h,cpp},
thrift_service.{h,cpp} (built under WITH_THRIFT).  Implements the Apache
Thrift framed transport (4-byte length prefix) with TBinaryProtocol
messages, no thrift library required: structs are described by field specs

    spec = {1: ("name", TType.STRING), 2: ("id", TType.I32)}

and travel as plain dicts.  Server side mirrors ThriftService: register a
method handler taking/returning dicts; client side calls through the normal
Channel machinery with protocol="thrift".

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/thrift.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..butil.iobuf import IOBuf
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import Protocol, ParseResult, register_protocol

VERSION_1 = 0x80010000

MSG_CALL = 1
MSG_REPLY = 2
MSG_EXCEPTION = 3
MSG_ONEWAY = 4


class TType:
    STOP = 0
    BOOL = 2
    BYTE = 3
    DOUBLE = 4
    I16 = 6
    I32 = 8
    I64 = 10
    STRING = 11
    STRUCT = 12
    MAP = 13
    SET = 14
    LIST = 15


# ---- TBinaryProtocol codec -------------------------------------------

class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def write(self, b: bytes) -> None:
        self.parts.append(b)

    def i8(self, v): self.write(struct.pack(">b", v))
    def i16(self, v): self.write(struct.pack(">h", v))
    def i32(self, v): self.write(struct.pack(">i", v))
    def u32(self, v): self.write(struct.pack(">I", v & 0xFFFFFFFF))
    def i64(self, v): self.write(struct.pack(">q", v))
    def double(self, v): self.write(struct.pack(">d", v))

    def string(self, v):
        if isinstance(v, str):
            v = v.encode()
        self.i32(len(v))
        self.write(v)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) < n:
            raise ValueError("truncated thrift data")
        self.pos += n
        return b

    def i8(self): return struct.unpack(">b", self.take(1))[0]
    def i16(self): return struct.unpack(">h", self.take(2))[0]
    def i32(self): return struct.unpack(">i", self.take(4))[0]
    def u32(self): return struct.unpack(">I", self.take(4))[0]
    def i64(self): return struct.unpack(">q", self.take(8))[0]
    def double(self): return struct.unpack(">d", self.take(8))[0]
    def string(self): return self.take(self.i32())


def _write_value(w: _Writer, ttype: int, value: Any, spec=None) -> None:
    if ttype == TType.BOOL:
        w.i8(1 if value else 0)
    elif ttype == TType.BYTE:
        w.i8(value)
    elif ttype == TType.I16:
        w.i16(value)
    elif ttype == TType.I32:
        w.i32(value)
    elif ttype == TType.I64:
        w.i64(value)
    elif ttype == TType.DOUBLE:
        w.double(value)
    elif ttype == TType.STRING:
        w.string(value)
    elif ttype == TType.STRUCT:
        write_struct(w, value, spec or {})
    elif ttype == TType.LIST or ttype == TType.SET:
        elem_type, elem_spec = spec
        w.i8(elem_type)
        w.i32(len(value))
        for item in value:
            _write_value(w, elem_type, item, elem_spec)
    elif ttype == TType.MAP:
        (ktype, kspec), (vtype, vspec) = spec
        w.i8(ktype); w.i8(vtype)
        w.i32(len(value))
        for k, v in value.items():
            _write_value(w, ktype, k, kspec)
            _write_value(w, vtype, v, vspec)
    else:
        raise TypeError(f"unsupported thrift type {ttype}")


def _read_value(r: _Reader, ttype: int, spec=None) -> Any:
    if ttype == TType.BOOL:
        return bool(r.i8())
    if ttype == TType.BYTE:
        return r.i8()
    if ttype == TType.I16:
        return r.i16()
    if ttype == TType.I32:
        return r.i32()
    if ttype == TType.I64:
        return r.i64()
    if ttype == TType.DOUBLE:
        return r.double()
    if ttype == TType.STRING:
        return r.string()
    if ttype == TType.STRUCT:
        return read_struct(r, spec or {})
    if ttype in (TType.LIST, TType.SET):
        elem_type = r.i8()
        n = r.i32()
        elem_spec = spec[1] if spec else None
        return [_read_value(r, elem_type, elem_spec) for _ in range(n)]
    if ttype == TType.MAP:
        ktype = r.i8(); vtype = r.i8()
        n = r.i32()
        kspec = spec[0][1] if spec else None
        vspec = spec[1][1] if spec else None
        return {_read_value(r, ktype, kspec): _read_value(r, vtype, vspec)
                for _ in range(n)}
    raise TypeError(f"unsupported thrift type {ttype}")


def write_struct(w: _Writer, values: Dict[str, Any],
                 spec: Dict[int, Tuple]) -> None:
    """spec: field_id -> (name, ttype[, sub_spec])."""
    for fid, field in spec.items():
        name, ttype = field[0], field[1]
        sub = field[2] if len(field) > 2 else None
        if name not in values or values[name] is None:
            continue
        w.i8(ttype)
        w.i16(fid)
        _write_value(w, ttype, values[name], sub)
    w.i8(TType.STOP)


def read_struct(r: _Reader, spec: Dict[int, Tuple]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    while True:
        ttype = r.i8()
        if ttype == TType.STOP:
            return out
        fid = r.i16()
        field = spec.get(fid)
        value = _read_value(r, ttype, field[2] if field and len(field) > 2
                            else None)
        if field is not None:
            out[field[0]] = value


def pack_message(name: str, msg_type: int, seqid: int,
                 payload: bytes) -> bytes:
    w = _Writer()
    w.u32(VERSION_1 | msg_type)
    w.string(name)
    w.i32(seqid)
    w.write(payload)
    body = w.getvalue()
    return struct.pack(">i", len(body)) + body


# ---- request/response objects ----------------------------------------

class ThriftMessage:
    """A call or reply: method name + struct dict + field spec."""

    def __init__(self, method: str = "", values: Optional[Dict] = None,
                 spec: Optional[Dict[int, Tuple]] = None,
                 response_spec: Optional[Dict[int, Tuple]] = None):
        self.method = method
        self.values = values or {}
        self.spec = spec or {}
        self.response_spec = response_spec or {}
        self.msg_type = MSG_CALL
        self.seqid = 0
        self.exception_text = ""


# ---- protocol callbacks ----------------------------------------------

def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    hdr = source.fetch(8)
    if hdr is None:
        return ParseResult.not_enough_data()
    frame_len = struct.unpack(">i", hdr[:4])[0]
    version = struct.unpack(">I", hdr[4:8])[0]
    if frame_len <= 0 or frame_len > (1 << 28) \
            or (version & 0xFFFF0000) != (VERSION_1 & 0xFFFF0000):
        return ParseResult.try_others()
    if len(source) < 4 + frame_len:
        return ParseResult.not_enough_data()
    source.pop_front(4)
    body = source.cut(frame_len).to_bytes()
    r = _Reader(body)
    ver = r.u32()
    msg = ThriftMessage()
    msg.msg_type = ver & 0xFF
    msg.method = r.string().decode()
    msg.seqid = r.i32()
    msg._raw_reader = r
    return ParseResult.ok(msg)


def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    if not isinstance(request, ThriftMessage):
        raise TypeError("thrift request must be a ThriftMessage")
    cntl._thrift_request = request
    w = _Writer()
    write_struct(w, request.values, request.spec)
    return IOBuf(w.getvalue())


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    req = cntl._thrift_request
    method = req.method or method_full_name.rpartition(".")[2]
    # thrift seqid is 31-bit; carry the low bits and correlate pipelined
    seqid = cid & 0x7FFFFFFF
    return IOBuf(pack_message(method, MSG_CALL, seqid,
                              payload.to_bytes()))


class _Ctx:
    __slots__ = ("cid", "response_spec")

    def __init__(self, cid, response_spec):
        self.cid = cid
        self.response_spec = response_spec


def _make_pipeline_ctx(cid: int, cntl: Controller):
    req = getattr(cntl, "_thrift_request", None)
    return _Ctx(cid, getattr(req, "response_spec", None) or {})


def process_response(msg: ThriftMessage, socket) -> None:
    from ..bthread import id as bthread_id
    # thrift replies carry a seqid: correlate by it (robust to reordering),
    # falling back to pipeline order for servers that zero the seqid
    with socket._pipeline_lock:
        ctx = None
        for i, c in enumerate(socket.pipelined_contexts):
            if (c.cid & 0x7FFFFFFF) == msg.seqid:
                ctx = socket.pipelined_contexts.pop(i)
                break
        if ctx is None and socket.pipelined_contexts:
            ctx = socket.pipelined_contexts.pop(0)
    if ctx is None:
        return
    rc, cntl = bthread_id.lock(ctx.cid)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    if msg.msg_type == MSG_EXCEPTION:
        exc = read_struct(msg._raw_reader, {1: ("message", TType.STRING)})
        cntl.set_failed(errors.ERESPONSE,
                        (exc.get("message") or b"thrift exception").decode(
                            "utf-8", "replace"))
        cntl.finish_parsed_response(ctx.cid)
        return
    # standard thrift reply struct: field 0 = success
    reply = read_struct(msg._raw_reader,
                        {0: ("success", TType.STRUCT, ctx.response_spec)})
    out = ThriftMessage(msg.method, reply.get("success", {}),
                        ctx.response_spec)
    out.msg_type = msg.msg_type
    out.seqid = msg.seqid
    cntl.response = out
    cntl.finish_parsed_response(ctx.cid)


class ThriftService:
    """Server-side dispatcher (thrift_service.h NsheadService-style): one
    handler per method, dicts in/out."""

    def __init__(self):
        self._methods: Dict[str, Tuple[Callable, Dict, Dict]] = {}

    def add_method(self, name: str, fn: Callable[[Dict], Dict],
                   arg_spec: Dict[int, Tuple],
                   result_spec: Dict[int, Tuple]) -> None:
        self._methods[name] = (fn, arg_spec, result_spec)

    def handle(self, msg: ThriftMessage) -> bytes:
        entry = self._methods.get(msg.method)
        if entry is None:
            w = _Writer()
            write_struct(w, {"message": f"unknown method {msg.method}"},
                         {1: ("message", TType.STRING)})
            return pack_message(msg.method, MSG_EXCEPTION, msg.seqid,
                                w.getvalue())
        fn, arg_spec, result_spec = entry
        try:
            args = read_struct(msg._raw_reader, arg_spec)
            result = fn(args)
            w = _Writer()
            write_struct(w, {"success": result},
                         {0: ("success", TType.STRUCT, result_spec)})
            return pack_message(msg.method, MSG_REPLY, msg.seqid,
                                w.getvalue())
        except Exception as e:
            w = _Writer()
            write_struct(w, {"message": f"{type(e).__name__}: {e}"},
                         {1: ("message", TType.STRING)})
            return pack_message(msg.method, MSG_EXCEPTION, msg.seqid,
                                w.getvalue())


def process_request(msg: ThriftMessage, socket, server) -> None:
    svc = getattr(server, "thrift_service", None)
    if svc is None:
        w = _Writer()
        write_struct(w, {"message": "no ThriftService on this server"},
                     {1: ("message", TType.STRING)})
        socket.write(IOBuf(pack_message(msg.method, MSG_EXCEPTION,
                                        msg.seqid, w.getvalue())))
        return
    socket.write(IOBuf(svc.handle(msg)))


PROTOCOL = Protocol(
    name="thrift",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
    pipelined=True,
    make_pipeline_ctx=_make_pipeline_ctx,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("thrift") is None:
        register_protocol(PROTOCOL)


_register()
