"""Memcached binary protocol (client side, pipelined).

Reference: src/brpc/policy/memcache_binary_protocol.cpp + memcache.{h,cpp}
— client-only, requests pipeline on one connection, responses correlate by
order (opaque is also carried for defense).  24-byte binary header per the
memcached binary spec.

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/memcache.py``: both packages' clients send a
memcached the same frames.  The responses claim their calls in the reader, in
arrival order (``process_inline``), so the messenger's concurrent
per-message dispatch cannot reorder a pipelined batch.
"""
from __future__ import annotations

import struct
from typing import Any, List

from ..butil.iobuf import IOBuf
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import Protocol, ParseResult, register_protocol

MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81

OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_REPLACE = 0x03
OP_DELETE = 0x04
OP_INCREMENT = 0x05
OP_DECREMENT = 0x06
OP_FLUSH = 0x08
OP_NOOP = 0x0A
OP_VERSION = 0x0B
OP_TOUCH = 0x1C

STATUS_OK = 0x0000
STATUS_KEY_NOT_FOUND = 0x0001
STATUS_KEY_EXISTS = 0x0002

_HDR = struct.Struct(">BBHBBHIIQ")     # magic op keylen extras dt status/vb bodylen opaque cas


class MemcacheRequest:
    def __init__(self):
        self._ops: List[bytes] = []

    def _add(self, opcode: int, key: bytes = b"", value: bytes = b"",
             extras: bytes = b"") -> None:
        body_len = len(extras) + len(key) + len(value)
        opaque = len(self._ops)
        hdr = _HDR.pack(MAGIC_REQUEST, opcode, len(key), len(extras), 0, 0,
                        body_len, opaque, 0)
        self._ops.append(hdr + extras + key + value)

    def get(self, key) -> None:
        self._add(OP_GET, _b(key))

    def set(self, key, value, flags: int = 0, exptime: int = 0) -> None:
        self._add(OP_SET, _b(key), _b(value),
                  struct.pack(">II", flags, exptime))

    def add(self, key, value, flags: int = 0, exptime: int = 0) -> None:
        self._add(OP_ADD, _b(key), _b(value),
                  struct.pack(">II", flags, exptime))

    def replace(self, key, value, flags: int = 0, exptime: int = 0) -> None:
        self._add(OP_REPLACE, _b(key), _b(value),
                  struct.pack(">II", flags, exptime))

    def delete(self, key) -> None:
        self._add(OP_DELETE, _b(key))

    def incr(self, key, delta: int = 1, initial: int = 0) -> None:
        self._add(OP_INCREMENT, _b(key),
                  extras=struct.pack(">QQI", delta, initial, 0))

    def decr(self, key, delta: int = 1, initial: int = 0) -> None:
        self._add(OP_DECREMENT, _b(key),
                  extras=struct.pack(">QQI", delta, initial, 0))

    def version(self) -> None:
        self._add(OP_VERSION)

    def op_count(self) -> int:
        return len(self._ops)

    def serialize(self) -> bytes:
        return b"".join(self._ops)


def _b(v) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


class MemcacheOpResponse:
    __slots__ = ("opcode", "status", "value", "cas", "flags")

    def __init__(self, opcode: int, status: int, value: bytes, cas: int,
                 flags: int):
        self.opcode = opcode
        self.status = status
        self.value = value
        self.cas = cas
        self.flags = flags

    def ok(self) -> bool:
        return self.status == STATUS_OK


class MemcacheResponse:
    def __init__(self):
        self.ops: List[MemcacheOpResponse] = []

    def op(self, i: int = 0) -> MemcacheOpResponse:
        return self.ops[i]


# ---- protocol callbacks ----------------------------------------------

def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    """Bundle every complete response frame into ONE message: pipelined
    responses must be consumed strictly in order (see redis.parse)."""
    head = source.fetch(1)
    if head is None:
        return ParseResult.not_enough_data()
    if head[0] not in (MAGIC_RESPONSE, MAGIC_REQUEST):
        return ParseResult.try_others()
    # 0x80/0x81 collide with small binary frames of other protocols (mongo
    # lengths 128/129); memcache is client-only (reference parity) — only
    # claim when a memcache call is outstanding on this socket
    if getattr(arg, "server", None) is not None or \
            not getattr(socket, "pipelined_contexts", None):
        return ParseResult.try_others()
    data = source.fetch(len(source))
    ops: List[MemcacheOpResponse] = []
    pos = 0
    while pos + 24 <= len(data):
        (magic, opcode, keylen, extraslen, _dt, status, bodylen, opaque,
         cas) = _HDR.unpack(data[pos:pos + 24])
        if pos + 24 + bodylen > len(data):
            break
        body = data[pos + 24:pos + 24 + bodylen]
        extras = body[:extraslen]
        value = body[extraslen + keylen:]
        flags = struct.unpack(">I", extras[:4])[0] if len(extras) >= 4 else 0
        ops.append(MemcacheOpResponse(opcode, status, value, cas, flags))
        pos += 24 + bodylen
    if not ops:
        return ParseResult.not_enough_data()
    source.pop_front(pos)
    return ParseResult.ok(ops)


def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    if not isinstance(request, MemcacheRequest):
        raise TypeError("memcache request must be a MemcacheRequest")
    cntl._memcache_expected = request.op_count()
    return IOBuf(request.serialize())


OP_SASL_AUTH = 0x21


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    out = IOBuf()
    # CouchbaseAuthenticator (policy/couchbase_authenticator.cpp): SASL
    # PLAIN auth precedes the first op on each connection; its response
    # is consumed via ctx.auth_skip
    sock = getattr(cntl, "_pack_socket", None)
    cntl._memcache_auth_skip = 0
    if cntl.auth_token and sock is not None and \
            not getattr(sock, "_memcache_authed", False):
        sock._memcache_authed = True
        mech = b"PLAIN"
        user, _, password = cntl.auth_token.partition(":")
        value = b"\x00" + user.encode() + b"\x00" + password.encode()
        out.append(_HDR.pack(MAGIC_REQUEST, OP_SASL_AUTH, len(mech), 0, 0,
                             0, len(mech) + len(value), 0, 0)
                   + mech + value)
        cntl._memcache_auth_skip = 1
    out.append(payload)
    return out


class _Ctx:
    __slots__ = ("cid", "expected", "ops", "auth_skip")

    def __init__(self, cid, expected):
        self.cid = cid
        self.expected = expected
        self.ops: List[MemcacheOpResponse] = []
        self.auth_skip = 0


def _make_pipeline_ctx(cid: int, cntl: Controller) -> _Ctx:
    skip = getattr(cntl, "_memcache_auth_skip", 0)
    ctx = _Ctx(cid, getattr(cntl, "_memcache_expected", 1) + skip)
    ctx.auth_skip = skip
    return ctx


def process_inline(bundle: List[MemcacheOpResponse], socket) -> bool:
    """Runs in the reader, in cut order: the ops go to the oldest
    outstanding calls (one call's ops may span several reads), so the
    messenger's concurrent dispatch cannot reorder them."""
    done = []
    with socket._pipeline_lock:
        ctxs = socket.pipelined_contexts
        for msg in bundle:
            if not ctxs:
                break
            ctx = ctxs[0]
            ctx.ops.append(msg)
            if len(ctx.ops) >= ctx.expected:
                done.append(ctxs.pop(0))
    bundle[:] = done
    return False


def process_response(done: List[_Ctx], socket) -> None:
    """Completes the calls whose ops the reader gathered."""
    from ..bthread import id as bthread_id
    for ctx in done:
        rc, cntl = bthread_id.lock(ctx.cid)
        if rc != 0 or cntl is None:
            continue
        auth_ops, user_ops = (ctx.ops[:ctx.auth_skip],
                              ctx.ops[ctx.auth_skip:])
        if any(not op.ok() for op in auth_ops):
            socket._memcache_authed = False
            cntl.set_failed(errors.ERPCAUTH, "memcache SASL auth failed")
        resp = MemcacheResponse()
        resp.ops = user_ops
        cntl.response = resp
        cntl.remote_side = socket.remote_side
        cntl.finish_parsed_response(ctx.cid)


PROTOCOL = Protocol(
    name="memcache",
    parse=parse,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_inline=process_inline,
    support_server=False,
    pipelined=True,
    make_pipeline_ctx=_make_pipeline_ctx,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("memcache") is None:
        register_protocol(PROTOCOL)


_register()
