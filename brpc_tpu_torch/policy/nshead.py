"""nshead: 36-byte-head framed protocol + extensible service adaptors.

Reference behavior: src/brpc/nshead.h (the head layout + magic
0xfb709394), src/brpc/policy/nshead_protocol.cpp (parse: magic check at
offset 24, then head+body cut; client correlation is stored per-connection
because the wire carries no correlation id, hence pooled/short connections
only), src/brpc/nshead_service.h (raw service contract) and
src/brpc/nshead_pb_service_adaptor.h (meta-parse → pb-dispatch →
serialize-back adaptor).

The nshead frame is the substrate for a whole legacy family (nova_pbrpc,
public_pbrpc, ubrpc): those register as client-side *variants* whose
responses are cut by this protocol and completed through the per-call
pipeline context (the analogue of the reference stashing the correlation id
on the Socket).

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/nshead.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..butil.iobuf import IOBuf
from ..butil import logging as log
from ..bthread import id as bthread_id
from ..proto import legacy_meta_pb2 as legacy_pb
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import (CONNECTION_TYPE_POOLED, CONNECTION_TYPE_SHORT,
                            Protocol, ParseResult, register_protocol)

NSHEAD_MAGIC = 0xFB709394
_HEAD = struct.Struct("<HHI16sIII")    # id ver log_id provider magic rsvd blen
HEAD_SIZE = _HEAD.size                 # 36
_MAGIC_OFF = 24                        # offsetof(nshead_t, magic_num)

NsheadMeta = legacy_pb.NsheadMeta


@dataclass
class NsheadHead:
    id: int = 0
    version: int = 0
    log_id: int = 0
    provider: bytes = b""
    magic_num: int = NSHEAD_MAGIC
    reserved: int = 0
    body_len: int = 0

    def pack(self) -> bytes:
        return _HEAD.pack(self.id & 0xFFFF, self.version & 0xFFFF,
                          self.log_id & 0xFFFFFFFF,
                          self.provider[:16], self.magic_num,
                          self.reserved & 0xFFFFFFFF, self.body_len)

    @staticmethod
    def unpack(raw: bytes) -> "NsheadHead":
        i, v, lid, prov, magic, rsvd, blen = _HEAD.unpack(raw[:HEAD_SIZE])
        return NsheadHead(i, v, lid, prov.rstrip(b"\x00"), magic, rsvd, blen)


class NsheadMessage:
    """head + raw body; both the request and response type of NsheadService."""
    __slots__ = ("head", "body")

    def __init__(self, head: Optional[NsheadHead] = None,
                 body: Optional[IOBuf] = None):
        self.head = head or NsheadHead()
        self.body = body if body is not None else IOBuf()

    def pack(self) -> IOBuf:
        self.head.body_len = len(self.body)
        out = IOBuf()
        out.append(self.head.pack())
        out.append(self.body)
        return out


class NsheadService:
    """Raw nshead server: subclass and override process_nshead_request.

    Call done() exactly once after filling `response` (async is fine —
    the reference's NsheadClosure works the same way)."""

    SERVICE_NAME = "nshead"

    def process_nshead_request(self, server, controller: Controller,
                               request: NsheadMessage,
                               response: NsheadMessage,
                               done: Callable[[], None]) -> None:
        raise NotImplementedError


class NsheadPbServiceAdaptor(NsheadService):
    """Bridge nshead frames onto protobuf services registered on the same
    server: parse dispatch meta from the raw request, run the pb method,
    serialize the pb response back into an nshead body."""

    def parse_nshead_meta(self, server, request: NsheadMessage,
                          controller: Controller,
                          meta: NsheadMeta) -> None:
        raise NotImplementedError

    def parse_request_from_iobuf(self, meta: NsheadMeta,
                                 request: NsheadMessage,
                                 controller: Controller, pb_req: Any) -> None:
        raise NotImplementedError

    def serialize_response_to_iobuf(self, meta: NsheadMeta,
                                    controller: Controller,
                                    pb_res: Any,
                                    response: NsheadMessage) -> None:
        raise NotImplementedError

    # the template method (reference: NsheadPbServiceAdaptor::
    # ProcessNsheadRequest in nshead_pb_service_adaptor.cpp)
    def process_nshead_request(self, server, controller, request, response,
                               done) -> None:
        meta = NsheadMeta()

        def fail_out() -> None:
            # the reference contract: SerializeResponseToIOBuf is called
            # with pb_res=NULL on failure so the adaptor can put error
            # information into the wire response (nshead itself has no
            # error channel; public_pbrpc etc. do)
            try:
                self.serialize_response_to_iobuf(meta, controller, None,
                                                 response)
            except Exception:
                pass
            done()

        # adaptor hooks run under exception guards: a raise must become a
        # protocol-level error response, not an empty-body reply
        try:
            self.parse_nshead_meta(server, request, controller, meta)
        except Exception as e:
            controller.set_failed(errors.EREQUEST,
                                  f"{type(e).__name__}: {e}")
        if controller.failed():
            fail_out()
            return
        md = server.find_method(meta.full_method_name)
        if md is None:
            controller.set_failed(errors.ENOMETHOD,
                                  f"no method {meta.full_method_name}")
            fail_out()
            return
        pb_req = md.request_cls()
        try:
            self.parse_request_from_iobuf(meta, request, controller, pb_req)
        except Exception as e:
            controller.set_failed(errors.EREQUEST,
                                  f"{type(e).__name__}: {e}")
        if controller.failed():
            fail_out()
            return
        pb_res = md.response_cls()
        fired = [False]

        def pb_done() -> None:
            if fired[0]:
                return
            fired[0] = True
            self.serialize_response_to_iobuf(meta, controller, pb_res,
                                             response)
            done()

        try:
            md.invoke(controller, pb_req, pb_res, pb_done)
        except Exception as e:
            log.error("nshead pb method %s raised: %s",
                      meta.full_method_name, e, exc_info=True)
            if not fired[0]:
                controller.set_failed(errors.EINTERNAL,
                                      f"{type(e).__name__}: {e}")
                pb_done()


# ---- client-variant plumbing -----------------------------------------
# The wire has no correlation id: each call pushes a context carrying the
# cid and a completion callback; responses pop contexts in order (pooled
# connections carry one call at a time, so order is trivially correct).

class NsheadCallCtx:
    __slots__ = ("cid", "complete", "proto_name", "extra")

    def __init__(self, cid: int, complete: Callable, proto_name: str,
                 extra: Any = None):
        self.cid = cid
        self.complete = complete
        self.proto_name = proto_name
        self.extra = extra


def _client_expects_nshead(socket) -> bool:
    ctxs = getattr(socket, "pipelined_contexts", None)
    return bool(ctxs) and isinstance(ctxs[0], NsheadCallCtx)


# ---- parse ------------------------------------------------------------

def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    """Identify by the magic at offset 24 (nshead_protocol.cpp pattern)."""
    server = getattr(arg, "server", None)
    if server is not None:
        if getattr(server, "_nshead_service", None) is None:
            return ParseResult.try_others()
    elif not _client_expects_nshead(socket):
        return ParseResult.try_others()
    probe = source.fetch(min(len(source), _MAGIC_OFF + 4))
    if probe is None or len(probe) < _MAGIC_OFF + 4:
        return ParseResult.not_enough_data()
    magic = int.from_bytes(probe[_MAGIC_OFF:_MAGIC_OFF + 4], "little")
    if magic != NSHEAD_MAGIC:
        return ParseResult.try_others()
    head_raw = source.fetch(HEAD_SIZE)
    if head_raw is None:
        return ParseResult.not_enough_data()
    head = NsheadHead.unpack(head_raw)
    if head.body_len > (1 << 31):
        return ParseResult.parse_error("absurd nshead body_len")
    if len(source) < HEAD_SIZE + head.body_len:
        return ParseResult.not_enough_data()
    source.pop_front(HEAD_SIZE)
    body = source.cut(head.body_len)
    return ParseResult.ok(NsheadMessage(head, body))


# ---- server side ------------------------------------------------------

def process_request(msg: NsheadMessage, socket, server) -> None:
    svc = getattr(server, "_nshead_service", None)
    if svc is None:
        socket.set_failed(errors.ENOSERVICE, "no nshead service")
        return
    cntl = Controller()
    cntl.server = server
    cntl.log_id = msg.head.log_id
    cntl.remote_side = socket.remote_side
    response = NsheadMessage()
    # response head defaults mirror the request envelope
    response.head = NsheadHead(id=msg.head.id, version=msg.head.version,
                               log_id=msg.head.log_id,
                               provider=msg.head.provider,
                               reserved=msg.head.reserved)
    fired = [False]

    def done() -> None:
        if fired[0]:
            return
        fired[0] = True
        socket.write(response.pack())
        if server_counted[0]:
            server.on_request_out()

    server_counted = [False]
    if not server.on_request_in():
        cntl.set_failed(errors.ELIMIT, "server max_concurrency reached")
        done()
        return
    server_counted[0] = True
    try:
        svc.process_nshead_request(server, cntl, msg, response, done)
    except Exception as e:
        log.error("nshead service raised: %s", e, exc_info=True)
        if not fired[0]:
            done()


# ---- client side (raw nshead calls) -----------------------------------

def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    if isinstance(request, NsheadMessage):
        cntl._nshead_head = request.head
        buf = IOBuf()
        buf.append(request.body)
        return buf
    if isinstance(request, (bytes, bytearray)):
        cntl._nshead_head = NsheadHead()
        return IOBuf(bytes(request))
    raise TypeError("nshead request must be NsheadMessage or bytes")


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    head: NsheadHead = getattr(cntl, "_nshead_head", None) or NsheadHead()
    head.log_id = head.log_id or cntl.log_id
    head.body_len = len(payload)
    out = IOBuf()
    out.append(head.pack())
    out.append(payload)
    return out


def _complete_raw(msg: NsheadMessage, socket, ctx: NsheadCallCtx) -> None:
    rc, cntl = bthread_id.lock(ctx.cid)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    cntl.response = msg
    cntl.finish_parsed_response(ctx.cid)


def make_pipeline_ctx(cid: int, cntl: Controller) -> NsheadCallCtx:
    return NsheadCallCtx(cid, _complete_raw, "nshead")


def process_response(msg: NsheadMessage, socket) -> None:
    ctx = socket.pop_pipelined_context()
    if ctx is None or not isinstance(ctx, NsheadCallCtx):
        log.warning("nshead response with no outstanding call; dropped")
        return
    ctx.complete(msg, socket, ctx)


PROTOCOL = Protocol(
    name="nshead",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
    supported_connection_type=CONNECTION_TYPE_POOLED | CONNECTION_TYPE_SHORT,
    pipelined=True,
    make_pipeline_ctx=make_pipeline_ctx,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("nshead") is None:
        register_protocol(PROTOCOL)


_register()
