"""tpu_std: the canonical framed protocol (the baidu_std analogue).

Reference behavior: src/brpc/policy/baidu_rpc_protocol.cpp — header, protobuf
RpcMeta, payload, then attachment; server path ProcessRpcRequest (:312),
response path SendRpcResponse (:139), client path ProcessRpcResponse
(:557).  The frame is magic "TRPC" + u32 meta_size + u32 body_size, then
the RpcMeta (proto/rpc_meta.proto) and the body.  The wire bytes are those
of the JAX package's tpu_std: the two interoperate frame for frame.
Streaming RPC rides it: the handshake in the request's
``stream_settings`` (``frame_type`` 4), the accepted id echoed on the
response, and stream frames (``correlation_id`` 0, no method) consumed in
reader order from both the server and the client parse paths
(:mod:`..rpc.stream`).

rpcz: a sampled call's trace, span and parent ids ride ``RpcMeta.request``
and the server opens its span in the caller's trace.  The server path is
split in five stages, each a LatencyRecorder ``tpu_std_server_<stage>``
and an annotation on the request's span:

  queue    frame cut on the read loop → process_request (dispatch, and
           the admission queue's wait when there is one)
  parse    the request's ParseFromString
  handler  md.invoke → done()
  encode   the response's meta, payload and frame
  write    socket.write

``tpu_std_stage_metrics`` picks how much: ``sampled`` (default) annotates
rpcz-sampled requests only, ``on`` also feeds the five recorders on every
request (a measurement run's mode), ``off`` records nothing.

With ``rpc_dump`` on, each request's frame goes to :mod:`..rpc.rpc_dump`
as it arrives.  A method registered isolated (``Server.register_isolated``)
runs on the usercode pool's isolation workers: its payload crosses as
bytes, its answer comes back as the response payload.
"""
from __future__ import annotations

import threading
import time
from typing import Any

from .. import bvar
from ..butil.iobuf import IOBuf
from ..butil import flags as _flags
from ..butil import logging as log
from ..bthread import id as bthread_id
from ..proto import rpc_meta_pb2 as meta_pb
from ..rpc import admission, compress as compress_mod, errors, rpc_dump
from ..rpc.controller import Controller, server_controller_pool
from ..rpc.protocol import (Protocol, ParseResult, find_protocol,
                            register_protocol)
from ..rpc.span import (start_server_span, end_server_span,
                        _rpcz_flag as _rpcz)
from ..rpc.stream import FRAME_HANDSHAKE

MAGIC = b"TRPC"
HEADER_SIZE = 12

_flags.define_flag("tpu_std_stage_metrics", "sampled",
                   "per-stage server latency decomposition: 'sampled' "
                   "(annotations on rpcz-sampled spans), 'on' (every "
                   "request + bvar recorders), 'off'")

_STAGES = ("queue", "parse", "handler", "encode", "write")
_stage_recorders = {s: bvar.LatencyRecorder(f"tpu_std_server_{s}")
                    for s in _STAGES}
# the Flag objects: one attribute load a request
_stage_flag = _flags.flag_object("tpu_std_stage_metrics")
_dump_flag = rpc_dump.dump_flag


class _RawPayload:
    """An isolated handler's answer: payload bytes already serialized."""
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    def SerializeToString(self) -> bytes:
        return self.data


def _stages_active(cntl: Controller) -> bool:
    """With rpcz on: 'on' times every request, 'sampled' the sampled
    ones, 'off' none."""
    mode = _stage_flag.value
    if mode == "sampled":
        return cntl.span is not None
    return mode == "on"


def _record_stage(stage: str, us: int, span) -> None:
    if _stage_flag.value == "on":
        _stage_recorders[stage] << us
    if span is not None:
        span.annotate(f"{stage}_us={us}")


def stage_p50s_us() -> dict:
    """Per-stage p50s (µs) of the tpu_std_server_* recorders, read from
    their lifetime reservoirs (a short run ends before the window's first
    tick); meaningful after a run with ``tpu_std_stage_metrics=on``."""
    return {s: _stage_recorders[s]._percentile.get_value().get_number(0.5)
            for s in _STAGES}


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
    if cntl.compress_type:
        data = compress_mod.compress(cntl.compress_type, data)
    buf.append(data)
    return buf


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    meta = meta_pb.RpcMeta()
    service, _, method_name = method_full_name.rpartition(".")
    meta.request.service_name = service
    meta.request.method_name = method_name
    if cntl.stream_creator is not None:     # stream handshake rides the RPC
        meta.stream_settings.stream_id = cntl.stream_creator.sid
        meta.stream_settings.frame_type = FRAME_HANDSHAKE
        meta.stream_settings.need_feedback = True
    meta.request.log_id = cntl.log_id
    meta.correlation_id = cid
    meta.compress_type = cntl.compress_type
    if cntl.auth_token:
        meta.request.auth_token = cntl.auth_token
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
    span = cntl.span
    if span is not None:
        meta.request.trace_id = span.trace_id
        meta.request.span_id = span.span_id
        meta.request.parent_span_id = span.parent_span_id
    body = IOBuf()
    body.append(payload)
    att_size = len(cntl.request_attachment)
    if att_size:
        meta.attachment_size = att_size
        body.append(cntl.request_attachment)
    return pack_frame(meta, body)


def process_inline(msg: StdMessage, socket) -> bool:
    """Reader-order consumption of stream frames (data, feedback, close):
    their relative order is the stream's byte order, so they never go
    through the concurrent per-message dispatch."""
    meta = msg.meta
    if (meta.correlation_id == 0 and not meta.request.service_name
            and meta.HasField("stream_settings")):
        from ..rpc.stream import on_stream_frame
        on_stream_frame(meta, msg.body, socket)
        return True
    return False


def process_response(msg: StdMessage, socket) -> None:
    """ProcessRpcResponse: lock the correlation id; stale versions fail to
    lock and the response is dropped (the retry-race resolution).  A
    response that echoes stream ids completes the caller's handshake."""
    cid = msg.meta.correlation_id
    rc, cntl = bthread_id.lock(cid)
    if rc != 0 or cntl is None:
        return                      # stale/duplicate/cancelled — ignore
    cntl.remote_side = socket.remote_side
    if (msg.meta.HasField("stream_settings")
            and cntl.stream_creator is not None):
        # handshake completion: the server accepted our stream
        cntl.stream_creator.mark_connected(
            msg.meta.stream_settings.remote_stream_id, socket)
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
    if _dump_flag.value:
        rpc_dump.maybe_dump_request(pack_frame(meta, msg.body))

    cntl = server_controller_pool.acquire()  # fablint: custody-moved(request-lifecycle) the shim rides the request; _maybe_recycle releases it back to the pool when the response (or failure path) completes
    cntl.server = server
    cntl.log_id = req_meta.log_id
    cntl.remote_side = socket.remote_side
    if req_meta.auth_token:
        cntl.auth_token = req_meta.auth_token
    if meta.compress_type:
        cntl.compress_type = meta.compress_type
    if req_meta.timeout_ms:
        cntl.method_deadline = time.monotonic() + req_meta.timeout_ms / 1e3
    # request context (offset-decoded priority; handlers may read)
    if req_meta.priority:
        cntl.priority = req_meta.priority - 1
    if req_meta.tenant:
        cntl.tenant = req_meta.tenant
    if req_meta.deadline_left_ms:
        cntl.deadline_left_ms = req_meta.deadline_left_ms
    if _rpcz.value:
        start_server_span(cntl, full_name, req_meta.trace_id,
                          req_meta.span_id)
        stages = _stages_active(cntl)
    else:
        # rpcz off: only the measurement mode times the stages
        stages = _stage_flag.value == "on"
    if stages and msg.recv_ns:
        _record_stage("queue", (time.monotonic_ns() - msg.recv_ns) // 1000,
                      cntl.span)
    md = server.find_method(full_name)
    status = server.method_status(full_name) if md is not None else None
    if status is not None:
        status.received << 1
    server_counted = False
    handler_t0 = 0

    def send_response(resp: Any = None) -> None:
        t_enc0 = time.monotonic_ns() if stages else 0
        if stages and handler_t0:
            _record_stage("handler", (t_enc0 - handler_t0) // 1000,
                          cntl.span)
        rmeta = meta_pb.RpcMeta()
        rmeta.correlation_id = cid
        rmeta.response.error_code = cntl.error_code_
        rmeta.response.error_text = cntl.error_text_
        if cntl.retry_after_ms:
            # shed hint: how long the client should back off
            rmeta.response.retry_after_ms = cntl.retry_after_ms
        if cntl.accepted_stream_id and not cntl.failed():
            # complete the stream handshake: echo the ids both ways
            from ..rpc.stream import find_stream
            srv_stream = find_stream(cntl.accepted_stream_id)
            client_sid = meta.stream_settings.stream_id
            if srv_stream is not None:
                rmeta.stream_settings.stream_id = client_sid
                rmeta.stream_settings.remote_stream_id = \
                    cntl.accepted_stream_id
                srv_stream.mark_connected(client_sid, socket)
        payload = IOBuf()
        if resp is not None and not cntl.failed():
            data = resp.SerializeToString()
            if meta.compress_type:
                # the response is compressed as the request was
                data = compress_mod.compress(meta.compress_type, data)
                rmeta.compress_type = meta.compress_type
            payload.append(data)
        resp_att = cntl._peek_response_attachment()
        att_size = len(resp_att) if resp_att is not None else 0
        if att_size:
            rmeta.attachment_size = att_size
            payload.append(resp_att)
        frame = pack_frame(rmeta, payload)
        if stages:
            t_wr0 = time.monotonic_ns()
            _record_stage("encode", (t_wr0 - t_enc0) // 1000, cntl.span)
            socket.write(frame)
            _record_stage("write", (time.monotonic_ns() - t_wr0) // 1000,
                          cntl.span)
        else:
            socket.write(frame)
        if cntl.span is not None:
            end_server_span(cntl)
        if status is not None:
            status.on_responded(cntl.error_code_,
                                time.monotonic_ns() // 1000 - start_us)
        if server_counted:
            server.on_request_out()

    def finish(resp: Any = None) -> None:
        # respond, then give back what the request held: its session data
        # and its pooled Controller
        send_response(resp)
        cntl._release_session_data()
        cntl._maybe_recycle()

    def reject(code: int, text: str, retry_after_ms: int = 0) -> None:
        # turned away before the method's gate: nothing to account
        nonlocal status
        status = None
        cntl.set_failed(code, text)
        if retry_after_ms:
            cntl.retry_after_ms = retry_after_ms
        finish()

    if server.is_draining():
        # lame duck: NEW requests bounce with retryable ELOGOFF so callers
        # fail over now; work admitted before the flip keeps running
        reject(errors.ELOGOFF, "server is draining (lame duck)")
        return

    def parse_and_invoke() -> None:
        # the gates are held; send_response accounts for them
        nonlocal handler_t0
        auth = server.options.auth
        if auth is not None and not auth.verify(cntl.auth_token, socket):
            # the protocol's verify hook: before any user code runs
            cntl.set_failed(errors.ERPCAUTH, "authentication failed")
            finish()
            return
        t_parse0 = time.monotonic_ns() if stages else 0
        try:
            body = msg.body
            if meta.attachment_size:
                keep = len(body) - meta.attachment_size
                payload_part = body.cut(keep)
                body.cutn(cntl.request_attachment, meta.attachment_size)
                body = payload_part
            data = body.to_bytes()
            if meta.compress_type:
                data = compress_mod.decompress(meta.compress_type, data)
            request = md.request_cls()
            request.ParseFromString(data)
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"fail to parse request: {e}")
            finish()
            return
        if stages:
            _record_stage("parse", (time.monotonic_ns() - t_parse0) // 1000,
                          cntl.span)

        response = md.response_cls()
        # taken by the one caller that responds: a handler may hand
        # ``done`` to another thread and return (an async handler
        # completes from a step loop), so a late or racing second caller
        # must neither respond again nor touch a Controller that a later
        # request already holds
        responding = threading.Lock()

        def respond() -> None:
            finish(response)

        def done() -> None:
            if responding.acquire(blocking=False):
                respond()

        handler_t0 = time.monotonic_ns() if stages else 0
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

    iso = server.isolated_method(full_name) if md is None else None
    if iso is not None:
        # a method served by the isolation workers (no MethodDescriptor)
        def run_isolated(deadline_left_ms: int) -> None:
            auth = server.options.auth
            if auth is not None and not auth.verify(cntl.auth_token,
                                                    socket):
                cntl.set_failed(errors.ERPCAUTH, "authentication failed")
                finish()
                return
            body = msg.body
            if meta.attachment_size:
                payload_part = body.cut(len(body) - meta.attachment_size)
                body.cutn(cntl.request_attachment, meta.attachment_size)
                body = payload_part
            pool = server.usercode_pool
            resp = None
            try:
                if pool is None:
                    raise RuntimeError("usercode pool stopped")
                # the wait on the worker is bounded by the request's own
                # budget when it carried one
                resp = _RawPayload(pool.call_isolated(
                    full_name, body.to_bytes(),
                    timeout=(deadline_left_ms / 1000.0
                             if deadline_left_ms else None)))
            except TimeoutError:
                cntl.set_failed(errors.ERPCTIMEDOUT,
                                f"isolated handler exceeded deadline "
                                f"({deadline_left_ms}ms)")
            except Exception as e:
                cntl.set_failed(errors.EINTERNAL, f"{type(e).__name__}: {e}")
            if resp is not None and iso[1] == "echo":
                cntl.response_attachment.append(cntl.request_attachment)
            finish(resp)

        def admitted_isolated(queued_us: int) -> None:
            nonlocal server_counted
            server_counted = True
            ddl = cntl.deadline_left_ms
            run_isolated(max(ddl - queued_us // 1000, 1) if ddl else 0)

        if server.admission is not None:
            server.admission.submit(
                priority=cntl.priority, tenant=cntl.tenant,
                deadline_left_ms=cntl.deadline_left_ms or None,
                recv_us=msg.recv_ns // 1000 if msg.recv_ns else start_us,
                try_enter=admission.server_method_gate(server, None),
                run=admitted_isolated, shed=reject)
            return
        if not server.on_request_in():
            reject(errors.ELIMIT, "server max_concurrency reached")
            return
        server_counted = True
        run_isolated(cntl.deadline_left_ms)
        return

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

    def admitted(queued_us: int) -> None:
        nonlocal server_counted
        server_counted = True
        if stages and queued_us:
            # the admission queue's wait is part of the queue stage
            _record_stage("queue", queued_us, cntl.span)
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
    process_inline=process_inline,
)


def _register() -> None:
    if find_protocol("tpu_std") is None:
        register_protocol(PROTOCOL)


_register()
