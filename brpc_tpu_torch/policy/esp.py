"""esp: packed-head message protocol (legacy UB ecosystem peer).

Reference behavior: src/brpc/esp_head.h (packed 32-byte head: from/to
addresses as u64 unions, msg, msg_id, body_len), src/brpc/esp_message.h
(EspMessage = head + raw body), src/brpc/policy/esp_protocol.cpp (client
side only; no correlation field → id stashed per connection, pooled/short
connections).  The head has no magic, so parse only claims bytes when an
esp call is outstanding on the socket — the same defensive gating the
memcache client uses here.

Extension beyond the reference: a minimal EspService raw server so the
protocol round-trips in-process (the reference can only test against
external esp servers).

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/esp.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..butil.iobuf import IOBuf
from ..butil import logging as log
from ..bthread import id as bthread_id
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import (CONNECTION_TYPE_POOLED, CONNECTION_TYPE_SHORT,
                            Protocol, ParseResult, register_protocol,
                            find_protocol)

_HEAD = struct.Struct("<QQIQi")       # from to msg msg_id body_len
HEAD_SIZE = _HEAD.size                # 32


@dataclass
class EspHead:
    from_addr: int = 0
    to_addr: int = 0
    msg: int = 0
    msg_id: int = 0
    body_len: int = 0

    def pack(self) -> bytes:
        return _HEAD.pack(self.from_addr, self.to_addr, self.msg,
                          self.msg_id, self.body_len)

    @staticmethod
    def unpack(raw: bytes) -> "EspHead":
        f, t, m, mid, blen = _HEAD.unpack(raw[:HEAD_SIZE])
        return EspHead(f, t, m, mid, blen)


class EspMessage:
    __slots__ = ("head", "body")

    def __init__(self, head: Optional[EspHead] = None,
                 body: Optional[IOBuf] = None):
        self.head = head or EspHead()
        self.body = body if body is not None else IOBuf()

    def pack(self) -> IOBuf:
        self.head.body_len = len(self.body)
        out = IOBuf()
        out.append(self.head.pack())
        out.append(self.body)
        return out


class EspService:
    """Raw esp server handler: override process_esp_request, call done()."""

    SERVICE_NAME = "esp"

    def process_esp_request(self, server, controller: Controller,
                            request: EspMessage, response: EspMessage,
                            done: Callable[[], None]) -> None:
        raise NotImplementedError


class _EspCtx:
    __slots__ = ("cid",)

    def __init__(self, cid: int):
        self.cid = cid


def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    server = getattr(arg, "server", None)
    if server is not None:
        if getattr(server, "_esp_service", None) is None:
            return ParseResult.try_others()
    else:
        ctxs = getattr(socket, "pipelined_contexts", None)
        if not ctxs or not isinstance(ctxs[0], _EspCtx):
            return ParseResult.try_others()
    head_raw = source.fetch(HEAD_SIZE)
    if head_raw is None:
        return ParseResult.not_enough_data()
    head = EspHead.unpack(head_raw)
    # the esp head has no magic: cap body_len tightly so garbage bytes on
    # a server hosting an EspService fail the connection rather than
    # stalling it waiting for gigabytes that will never arrive
    if head.body_len < 0 or head.body_len > (16 << 20):
        return ParseResult.parse_error("absurd esp body_len")
    if len(source) < HEAD_SIZE + head.body_len:
        return ParseResult.not_enough_data()
    source.pop_front(HEAD_SIZE)
    body = source.cut(head.body_len)
    return ParseResult.ok(EspMessage(head, body))


def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    if not isinstance(request, EspMessage):
        raise TypeError("esp request must be an EspMessage")
    cntl._esp_head = request.head
    buf = IOBuf()
    buf.append(request.body)
    return buf


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    head: EspHead = getattr(cntl, "_esp_head", None) or EspHead()
    head.body_len = len(payload)
    out = IOBuf()
    out.append(head.pack())
    out.append(payload)
    return out


def make_pipeline_ctx(cid: int, cntl: Controller) -> _EspCtx:
    return _EspCtx(cid)


def process_response(msg: EspMessage, socket) -> None:
    ctx = socket.pop_pipelined_context()
    if ctx is None or not isinstance(ctx, _EspCtx):
        log.warning("esp response with no outstanding call; dropped")
        return
    rc, cntl = bthread_id.lock(ctx.cid)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    cntl.response = msg
    cntl.finish_parsed_response(ctx.cid)


def process_request(msg: EspMessage, socket, server) -> None:
    svc = getattr(server, "_esp_service", None)
    if svc is None:
        socket.set_failed(errors.ENOSERVICE, "no esp service")
        return
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = socket.remote_side
    response = EspMessage()
    response.head = EspHead(from_addr=msg.head.to_addr,
                            to_addr=msg.head.from_addr,
                            msg=msg.head.msg, msg_id=msg.head.msg_id)
    fired = [False]
    counted = [False]

    def done() -> None:
        if fired[0]:
            return
        fired[0] = True
        socket.write(response.pack())
        if counted[0]:
            server.on_request_out()

    if not server.on_request_in():
        cntl.set_failed(errors.ELIMIT, "server max_concurrency reached")
        done()
        return
    counted[0] = True
    try:
        svc.process_esp_request(server, cntl, msg, response, done)
    except Exception as e:
        log.error("esp service raised: %s", e, exc_info=True)
        if not fired[0]:
            done()


PROTOCOL = Protocol(
    name="esp",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
    supported_connection_type=CONNECTION_TYPE_POOLED | CONNECTION_TYPE_SHORT,
    pipelined=True,
    make_pipeline_ctx=make_pipeline_ctx,
)


if find_protocol("esp") is None:
    register_protocol(PROTOCOL)
