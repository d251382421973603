"""Mongo wire protocol: OP_MSG/OP_QUERY server adaptor + client.

Reference: src/brpc/policy/mongo_protocol.cpp (298 L), src/brpc/mongo_head.h
(16-byte little-endian head: message_length, request_id, response_to,
op_code; `is_mongo_opcode` gate at mongo_head.h:40),
src/brpc/mongo_service_adaptor.h — the reference hands the raw message to a
user adaptor and leaves BSON to user code.  This build keeps that adaptor
shape (``MongoService.process``) and additionally ships a minimal BSON
codec so the adaptor is usable without external drivers (none in the
image).

Client:
    ch.init(target, options=ChannelOptions(protocol="mongo"))
    req = MongoRequest({"ping": 1, "$db": "admin"})
    resp = ch.call_method("mongo", cntl, req, MongoResponse)
    resp.doc   # decoded BSON reply document

Server:
    class MyMongo(MongoService):
        def process(self, cntl, doc):     # doc: decoded request document
            return {"ok": 1}
    server.add_mongo_service(MyMongo())   # via Server.add_service too

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/mongo.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..butil.iobuf import IOBuf
from ..bthread import id as bthread_id
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import (Protocol, ParseResult, register_protocol)

# ---- opcodes (mongo_head.h:27-58) -------------------------------------

OP_REPLY = 1
OP_UPDATE = 2001
OP_INSERT = 2002
OP_QUERY = 2004
OP_GET_MORE = 2005
OP_DELETE = 2006
OP_KILL_CURSORS = 2007
OP_COMPRESSED = 2012
OP_MSG = 2013

_KNOWN_OPCODES = {OP_REPLY, OP_UPDATE, OP_INSERT, OP_QUERY, OP_GET_MORE,
                  OP_DELETE, OP_KILL_CURSORS, OP_COMPRESSED, OP_MSG}

HEAD_SIZE = 16
_MAX_MESSAGE = 48 * 1024 * 1024     # mongo's maxMessageSizeBytes


class MongoHead:
    """16-byte little-endian message head (mongo_head.h:60-78)."""
    __slots__ = ("message_length", "request_id", "response_to", "op_code")

    def __init__(self, message_length=0, request_id=0, response_to=0,
                 op_code=OP_MSG):
        self.message_length = message_length
        self.request_id = request_id
        self.response_to = response_to
        self.op_code = op_code

    def pack(self) -> bytes:
        return struct.pack("<iiii", self.message_length, self.request_id,
                           self.response_to, self.op_code)

    @staticmethod
    def unpack(data: bytes) -> "MongoHead":
        ml, rid, rto, op = struct.unpack("<iiii", data[:HEAD_SIZE])
        return MongoHead(ml, rid, rto, op)


# ---- minimal BSON codec -----------------------------------------------
# Types: double, string, document, array, binary, bool, null, int32,
# int64 — the working set for command documents.  (The reference ships no
# BSON at all; this is a usability addition, not a parity requirement.)

def _bson_encode_value(name: bytes, v: Any) -> bytes:
    if isinstance(v, bool):                       # before int check!
        return b"\x08" + name + b"\x00" + (b"\x01" if v else b"\x00")
    if isinstance(v, float):
        return b"\x01" + name + b"\x00" + struct.pack("<d", v)
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + name + b"\x00" + struct.pack("<i", v)
        return b"\x12" + name + b"\x00" + struct.pack("<q", v)
    if isinstance(v, str):
        enc = v.encode() + b"\x00"
        return b"\x02" + name + b"\x00" + struct.pack("<i", len(enc)) + enc
    if isinstance(v, (bytes, bytearray)):
        return (b"\x05" + name + b"\x00" + struct.pack("<i", len(v))
                + b"\x00" + bytes(v))             # subtype 0 generic
    if v is None:
        return b"\x0a" + name + b"\x00"
    if isinstance(v, dict):
        return b"\x03" + name + b"\x00" + bson_encode(v)
    if isinstance(v, (list, tuple)):
        doc = {str(i): x for i, x in enumerate(v)}
        return b"\x04" + name + b"\x00" + bson_encode(doc)
    raise TypeError(f"BSON cannot encode {type(v)}")


def bson_encode(doc: Dict[str, Any]) -> bytes:
    body = b"".join(_bson_encode_value(k.encode(), v)
                    for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _bson_decode_doc(data: bytes, off: int) -> Tuple[Dict[str, Any], int]:
    (total,) = struct.unpack_from("<i", data, off)
    end = off + total - 1                 # trailing NUL
    off += 4
    out: Dict[str, Any] = {}
    while off < end:
        t = data[off]
        off += 1
        nul = data.index(b"\x00", off)
        name = data[off:nul].decode()
        off = nul + 1
        if t == 0x01:
            (out[name],) = struct.unpack_from("<d", data, off); off += 8
        elif t == 0x02:
            (n,) = struct.unpack_from("<i", data, off); off += 4
            out[name] = data[off:off + n - 1].decode(); off += n
        elif t == 0x03:
            out[name], off = _bson_decode_doc(data, off)
        elif t == 0x04:
            sub, off = _bson_decode_doc(data, off)
            out[name] = [sub[str(i)] for i in range(len(sub))]
        elif t == 0x05:
            (n,) = struct.unpack_from("<i", data, off); off += 5  # +subtype
            out[name] = data[off:off + n]; off += n
        elif t == 0x08:
            out[name] = data[off] != 0; off += 1
        elif t == 0x09:                    # UTC datetime: surface as int64 ms
            (out[name],) = struct.unpack_from("<q", data, off); off += 8
        elif t == 0x0a:
            out[name] = None
        elif t == 0x10:
            (out[name],) = struct.unpack_from("<i", data, off); off += 4
        elif t == 0x11 or t == 0x12:       # timestamp / int64
            (out[name],) = struct.unpack_from("<q", data, off); off += 8
        else:
            raise ValueError(f"BSON type 0x{t:02x} unsupported")
    return out, end + 1


def bson_decode(data: bytes) -> Dict[str, Any]:
    doc, _ = _bson_decode_doc(bytes(data), 0)
    return doc


# ---- OP_MSG body ------------------------------------------------------

def _pack_op_msg(doc: Dict[str, Any], flags: int = 0) -> bytes:
    return struct.pack("<I", flags) + b"\x00" + bson_encode(doc)


def _parse_op_msg(body: bytes) -> Dict[str, Any]:
    """Parse an OP_MSG body: kind-0 section is the command document;
    kind-1 document sequences are folded in as a list under their name."""
    (flags,) = struct.unpack_from("<I", body, 0)
    off = 4
    doc: Dict[str, Any] = {}
    if flags & 0x1:                        # checksumPresent: ignore CRC tail
        body = body[:-4]
    while off < len(body):
        kind = body[off]
        off += 1
        if kind == 0:
            d, off = _bson_decode_doc(body, off)
            doc.update(d)
        elif kind == 1:
            (sec_len,) = struct.unpack_from("<i", body, off)
            sec_end = off + sec_len
            p = off + 4
            nul = body.index(b"\x00", p)
            name = body[p:nul].decode()
            p = nul + 1
            docs: List[Dict[str, Any]] = []
            while p < sec_end:
                d, p = _bson_decode_doc(body, p)
                docs.append(d)
            doc[name] = docs
            off = sec_end
        else:
            raise ValueError(f"OP_MSG section kind {kind}")
    return doc


class MongoMessage:
    __slots__ = ("head", "body")

    def __init__(self, head: MongoHead, body: bytes):
        self.head = head
        self.body = body

    @property
    def doc(self) -> Dict[str, Any]:
        if self.head.op_code == OP_MSG:
            return _parse_op_msg(self.body)
        if self.head.op_code == OP_QUERY:
            # flags(4) + cstring collection + skip(4) + limit(4) + doc
            off = 4
            off = self.body.index(b"\x00", off) + 1
            off += 8
            d, _ = _bson_decode_doc(self.body, off)
            return d
        raise ValueError(f"cannot decode opcode {self.head.op_code}")


# ---- request/response value types -------------------------------------

class MongoRequest:
    def __init__(self, doc: Dict[str, Any], op_code: int = OP_MSG):
        self.doc = doc
        self.op_code = op_code


class MongoResponse:
    def __init__(self):
        self.doc: Dict[str, Any] = {}
        self.head: Optional[MongoHead] = None


# ---- server adaptor (mongo_service_adaptor.h equivalent) ---------------

class MongoService:
    """Subclass and override process(); register on a Server.  The server
    dispatches every mongo message here (there is no method routing in the
    mongo wire protocol — the command is inside the document)."""

    SERVICE_NAME = "mongo"

    def methods(self):                     # Server.add_service compatibility
        return {}

    def process(self, cntl: Controller, doc: Dict[str, Any]
                ) -> Optional[Dict[str, Any]]:
        raise NotImplementedError


# ---- correlation: request_id(int32) → versioned cid --------------------

_corr_lock = threading.Lock()
_corr: Dict[int, Tuple[int, float]] = {}    # rid -> (cid, expiry)
_next_req_id = [1]
_CORR_TTL = 130.0        # > any sane rpc timeout; sweeps dead entries
_SWEEP_EVERY = 256
_calls_since_sweep = [0]


def _new_request_id(cid: int, ttl: Optional[float] = None) -> int:
    import time as _time
    now = _time.monotonic()
    with _corr_lock:
        _calls_since_sweep[0] += 1
        if _calls_since_sweep[0] >= _SWEEP_EVERY:
            # calls whose response never arrived (timeout, dead peer) must
            # not accumulate forever, nor mis-correlate after rid wrap
            _calls_since_sweep[0] = 0
            dead = [r for r, (_, exp) in _corr.items() if exp < now]
            for r in dead:
                del _corr[r]
        rid = _next_req_id[0]
        _next_req_id[0] = (rid + 1) & 0x7FFFFFFF or 1
        _corr[rid] = (cid, now + (ttl if ttl else _CORR_TTL))
        return rid


def _take_cid(response_to: int) -> Optional[int]:
    with _corr_lock:
        ent = _corr.pop(response_to, None)
        return ent[0] if ent is not None else None


# ---- protocol hooks ----------------------------------------------------

def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    head_bytes = source.fetch(HEAD_SIZE)
    if head_bytes is None:
        # not enough for a head: could still be mongo — but reject quickly
        # if the partial opcode can't match (the reference returns
        # TRY_OTHERS on bad opcode only once the head is complete)
        return ParseResult.not_enough_data()
    head = MongoHead.unpack(head_bytes)
    if head.op_code not in _KNOWN_OPCODES or \
            head.message_length < HEAD_SIZE or \
            head.message_length > _MAX_MESSAGE:
        return ParseResult.try_others()
    if len(source) < head.message_length:
        return ParseResult.not_enough_data()
    source.pop_front(HEAD_SIZE)
    body = source.cut(head.message_length - HEAD_SIZE).to_bytes()
    return ParseResult.ok(MongoMessage(head, body))


def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    if isinstance(request, MongoRequest):
        body = _pack_op_msg(request.doc)
        cntl._mongo_opcode = request.op_code
    elif isinstance(request, dict):
        body = _pack_op_msg(request)
        cntl._mongo_opcode = OP_MSG
    else:
        raise TypeError("mongo request must be MongoRequest or dict")
    return IOBuf(body)


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    ttl = (cntl.timeout_ms / 1000.0 + 30.0) if cntl.timeout_ms else None
    rid = _new_request_id(cid, ttl)
    body = payload.to_bytes()
    head = MongoHead(HEAD_SIZE + len(body), rid, 0,
                     getattr(cntl, "_mongo_opcode", OP_MSG))
    out = IOBuf()
    out.append(head.pack())
    out.append(body)
    return out


def process_response(msg: MongoMessage, socket) -> None:
    cid = _take_cid(msg.head.response_to)
    if cid is None:
        return                              # stale/unknown: drop
    rc, cntl = bthread_id.lock(cid)
    if rc != 0 or cntl is None:
        return
    resp = MongoResponse()
    resp.head = msg.head
    try:
        resp.doc = msg.doc
    except Exception as e:
        cntl.set_failed(errors.ERESPONSE, f"bad mongo reply: {e}")
        cntl.finish_parsed_response(cid)
        return
    cntl.response = resp
    cntl.finish_parsed_response(cid)


def process_request(msg: MongoMessage, socket, server) -> None:
    svc = None
    for s in getattr(server, "_services", {}).values():
        if isinstance(s, MongoService):
            svc = s
            break
    if svc is None:
        svc = getattr(server, "_mongo_service", None)
    err_doc = None
    reply: Optional[Dict[str, Any]] = None
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = socket.remote_side
    if svc is None:
        err_doc = {"ok": 0, "errmsg": "no MongoService registered",
                   "code": errors.ENOSERVICE}
    else:
        try:
            reply = svc.process(cntl, msg.doc)
        except Exception as e:
            err_doc = {"ok": 0, "errmsg": f"{type(e).__name__}: {e}",
                       "code": errors.EINTERNAL}
    out_doc = err_doc if err_doc is not None else (
        reply if reply is not None else {"ok": 1})
    body = _pack_op_msg(out_doc)
    head = MongoHead(HEAD_SIZE + len(body), 0, msg.head.request_id, OP_MSG)
    out = IOBuf()
    out.append(head.pack())
    out.append(body)
    socket.write(out)


PROTOCOL = Protocol(
    name="mongo",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("mongo") is None:
        register_protocol(PROTOCOL)


_register()
