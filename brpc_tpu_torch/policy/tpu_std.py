"""tpu_std: the canonical framed protocol (the baidu_std analogue).

Reference behavior: src/brpc/policy/baidu_rpc_protocol.cpp — header, protobuf
RpcMeta, payload, then attachment; server path ProcessRpcRequest (:312),
response path SendRpcResponse (:139), client path ProcessRpcResponse
(:557).  The frame is magic "TRPC" + u32 meta_size + u32 body_size, then
the RpcMeta (proto/rpc_meta.proto) and the body.  The wire bytes are those
of the JAX package's tpu_std: the two interoperate frame for frame.
"""
from __future__ import annotations

import threading
import time
from typing import Any

from ..butil.iobuf import IOBuf
from ..butil import logging as log
from ..bthread import id as bthread_id
from ..proto import rpc_meta_pb2 as meta_pb
from ..rpc import admission, errors
from ..rpc.controller import Controller, server_controller_pool
from ..rpc.protocol import (Protocol, ParseResult, find_protocol,
                            register_protocol)

MAGIC = b"TRPC"
HEADER_SIZE = 12


class StdMessage:
    """A cut but not yet parsed frame.  ``recv_ns`` stamps the cut: the
    admission layer charges a request's deadline budget from there."""
    __slots__ = ("meta", "body", "recv_ns")

    def __init__(self, meta: meta_pb.RpcMeta, body: IOBuf):
        self.meta = meta
        self.body = body
        self.recv_ns = 0


# ---- frame codec ------------------------------------------------------

def pack_frame(meta: meta_pb.RpcMeta, payload: IOBuf) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(MAGIC + len(meta_bytes).to_bytes(4, "big")
               + len(payload).to_bytes(4, "big") + meta_bytes)
    out.append(payload)            # zero-copy ref share (device blocks ride)
    return out


def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    header = source.fetch(HEADER_SIZE)
    if header is None:
        prefix = source.fetch(min(len(source), 4)) or b""
        if MAGIC.startswith(prefix):
            return ParseResult.not_enough_data()
        return ParseResult.try_others()
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    meta_size = int.from_bytes(header[4:8], "big")
    body_size = int.from_bytes(header[8:12], "big")
    if meta_size > (1 << 26) or body_size > (1 << 31):
        return ParseResult.parse_error("absurd frame sizes")
    total = HEADER_SIZE + meta_size + body_size
    if len(source) < total:
        return ParseResult.not_enough_data()
    source.pop_front(HEADER_SIZE)
    meta_buf = source.cut(meta_size)
    body = source.cut(body_size)
    meta = meta_pb.RpcMeta()
    try:
        meta.ParseFromString(meta_buf.to_bytes())
    except Exception as e:
        return ParseResult.parse_error(f"bad meta: {e}")
    msg = StdMessage(meta, body)
    msg.recv_ns = time.monotonic_ns()
    return ParseResult.ok(msg)


# ---- client side ------------------------------------------------------

def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    buf = IOBuf()
    if request is None:
        return buf
    if hasattr(request, "SerializeToString"):
        data = request.SerializeToString()
    elif isinstance(request, (bytes, bytearray)):
        data = bytes(request)
    else:
        raise TypeError(f"cannot serialize {type(request)}")
    buf.append(data)
    return buf


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    meta = meta_pb.RpcMeta()
    service, _, method_name = method_full_name.rpartition(".")
    meta.request.service_name = service
    meta.request.method_name = method_name
    meta.request.log_id = cntl.log_id
    meta.correlation_id = cid
    if cntl.timeout_ms:
        meta.request.timeout_ms = cntl.timeout_ms
        # deadline budget REMAINING at send time: total budget minus what
        # this caller already spent
        elapsed_ms = (time.monotonic_ns() // 1000
                      - cntl._start_us) / 1000.0 if cntl._start_us else 0.0
        meta.request.deadline_left_ms = max(
            int(cntl.timeout_ms - elapsed_ms), 1)
    if cntl.priority is not None:
        # offset-encoded: 0 on the wire = unset (server default band)
        meta.request.priority = cntl.priority + 1
    if cntl.tenant:
        meta.request.tenant = cntl.tenant
    body = IOBuf()
    body.append(payload)
    att_size = len(cntl.request_attachment)
    if att_size:
        meta.attachment_size = att_size
        body.append(cntl.request_attachment)
    return pack_frame(meta, body)


def process_response(msg: StdMessage, socket) -> None:
    """ProcessRpcResponse: lock the correlation id; stale versions fail to
    lock and the response is dropped (the retry-race resolution)."""
    cid = msg.meta.correlation_id
    rc, cntl = bthread_id.lock(cid)
    if rc != 0 or cntl is None:
        return                      # stale/duplicate/cancelled — ignore
    cntl.remote_side = socket.remote_side
    cntl.handle_response(cid, msg.meta, msg.body)


# ---- server side ------------------------------------------------------

def process_request(msg: StdMessage, socket, server) -> None:
    """ProcessRpcRequest (baidu_rpc_protocol.cpp:312): find the method,
    pass the server's gates, run user code in this tasklet, respond via
    socket write.  The gates, in order: a draining server bounces with
    retryable ELOGOFF; then either the admission controller decides
    (admit, queue, or shed with a ``retry_after_ms`` hint) or, without
    one, the server's ``max_concurrency`` and the method's limiter reject
    at the gate with ELIMIT.  A request turned away never reaches its
    MethodStatus (a shed is not a method failure).  The per-request
    Controller comes from the server-side pool and is recycled once the
    response is written, by whichever thread calls ``done``: recycling
    drops the request's attachment, so a shed request's received tensor
    is released with its response."""
    meta = msg.meta
    req_meta = meta.request
    full_name = f"{req_meta.service_name}.{req_meta.method_name}"
    cid = meta.correlation_id
    start_us = time.monotonic_ns() // 1000

    cntl = server_controller_pool.acquire()
    cntl.log_id = req_meta.log_id
    cntl.remote_side = socket.remote_side
    # request context (offset-decoded priority; handlers may read)
    if req_meta.priority:
        cntl.priority = req_meta.priority - 1
    if req_meta.tenant:
        cntl.tenant = req_meta.tenant
    if req_meta.deadline_left_ms:
        cntl.deadline_left_ms = req_meta.deadline_left_ms
    md = server.find_method(full_name)
    status = server.method_status(full_name) if md is not None else None
    if status is not None:
        status.received << 1
    server_counted = False

    def send_response(resp: Any = None) -> None:
        rmeta = meta_pb.RpcMeta()
        rmeta.correlation_id = cid
        rmeta.response.error_code = cntl.error_code_
        rmeta.response.error_text = cntl.error_text_
        if cntl.retry_after_ms:
            # shed hint: how long the client should back off
            rmeta.response.retry_after_ms = cntl.retry_after_ms
        payload = IOBuf()
        if resp is not None and not cntl.failed():
            payload.append(resp.SerializeToString())
        resp_att = cntl._peek_response_attachment()
        att_size = len(resp_att) if resp_att is not None else 0
        if att_size:
            rmeta.attachment_size = att_size
            payload.append(resp_att)
        socket.write(pack_frame(rmeta, payload))
        if status is not None:
            status.on_responded(cntl.error_code_,
                                time.monotonic_ns() // 1000 - start_us)
        if server_counted:
            server.on_request_out()

    def reject(code: int, text: str, retry_after_ms: int = 0) -> None:
        # turned away before the method's gate: nothing to account
        nonlocal status
        status = None
        cntl.set_failed(code, text)
        if retry_after_ms:
            cntl.retry_after_ms = retry_after_ms
        send_response()
        cntl._maybe_recycle()

    if server.is_draining():
        # lame duck: NEW requests bounce with retryable ELOGOFF so callers
        # fail over now; work admitted before the flip keeps running
        reject(errors.ELOGOFF, "server is draining (lame duck)")
        return

    def parse_and_invoke() -> None:
        # the gates are held; send_response accounts for them
        try:
            body = msg.body
            if meta.attachment_size:
                keep = len(body) - meta.attachment_size
                payload_part = body.cut(keep)
                body.cutn(cntl.request_attachment, meta.attachment_size)
                body = payload_part
            request = md.request_cls()
            request.ParseFromString(body.to_bytes())
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"fail to parse request: {e}")
            send_response()
            cntl._maybe_recycle()
            return

        response = md.response_cls()
        # taken by the one caller that responds: a handler may hand
        # ``done`` to another thread and return (an async handler
        # completes from a step loop), so a late or racing second caller
        # must neither respond again nor touch a Controller that a later
        # request already holds
        responding = threading.Lock()

        def respond() -> None:
            send_response(response)
            cntl._maybe_recycle()

        def done() -> None:
            if responding.acquire(blocking=False):
                respond()

        try:
            md.invoke(cntl, request, response, done)
        except Exception as e:   # uncaught user exception → EINTERNAL
            log.error("method %s raised: %s", full_name, e, exc_info=True)
            if responding.acquire(blocking=False):
                cntl.set_failed(errors.EINTERNAL,
                                f"{type(e).__name__}: {e}")
                respond()

    def no_method() -> None:
        reject(errors.ENOMETHOD if req_meta.service_name in
               server.services() else errors.ENOSERVICE,
               f"no method {full_name}")

    adm = server.admission
    if adm is None:
        # reject at the gate (no admission layer)
        if not server.on_request_in():
            reject(errors.ELIMIT, "server max_concurrency reached")
            return
        server_counted = True
        if md is None:
            no_method()
            return
        if status is not None and not status.on_requested():
            reject(errors.ELIMIT,
                   f"method {full_name} max_concurrency reached")
            return
        parse_and_invoke()
        return

    # the admission path: the controller admits, queues or sheds
    if md is None:
        no_method()
        return

    def admitted(_queued_us: int) -> None:
        nonlocal server_counted
        server_counted = True
        parse_and_invoke()

    adm.submit(priority=cntl.priority, tenant=cntl.tenant,
               deadline_left_ms=cntl.deadline_left_ms or None,
               recv_us=msg.recv_ns // 1000 if msg.recv_ns else start_us,
               try_enter=admission.server_method_gate(server, status),
               run=admitted, shed=reject)


PROTOCOL = Protocol(
    name="tpu_std",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
)


def _register() -> None:
    if find_protocol("tpu_std") is None:
        register_protocol(PROTOCOL)


_register()
