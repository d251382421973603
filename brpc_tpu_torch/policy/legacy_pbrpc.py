"""hulu-pbrpc and sofa-pbrpc: legacy framed protobuf protocols.

Reference behavior:
- src/brpc/policy/hulu_pbrpc_protocol.cpp — frame "HULU" + u32le
  (meta_size+payload_size) + u32le meta_size, then HuluRpcRequestMeta /
  HuluRpcResponseMeta + payload.  Correlation id travels in the meta, so
  single connections work.  Dispatch is by (service_name, method_index)
  with a later method_name override.
- src/brpc/policy/sofa_pbrpc_protocol.cpp — frame "SOFA" + u32le meta_size
  + u64le body_size + u64le total_size, then SofaRpcMeta + body.  One meta
  message for both directions (type=REQUEST|RESPONSE), correlation by
  sequence_id, method addressed by full name.

Both are registered client+server; frames interop with this stack's own
peers (there are no external hulu/sofa speakers to interop with — the value
is the registry exercising two more Protocol shapes, exactly like the
reference keeps them alive as extension examples).

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/legacy_pbrpc.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Any

from ..butil.iobuf import IOBuf
from ..butil import logging as log
from ..bthread import id as bthread_id
from ..proto import legacy_meta_pb2 as legacy_pb
from ..rpc import errors
from ..rpc import compress as compress_mod
from ..rpc.controller import Controller
from ..rpc.protocol import (Protocol, ParseResult, register_protocol,
                            find_protocol)

HULU_MAGIC = b"HULU"
SOFA_MAGIC = b"SOFA"


class _Frame:
    __slots__ = ("meta", "body")

    def __init__(self, meta, body: IOBuf):
        self.meta = meta
        self.body = body


def _resp_meta_shim(error_code: int, error_text: str, compress_type: int):
    """Adapter so Controller.handle_response (written for tpu_std's RpcMeta)
    can drive retry/parse for legacy metas."""
    return SimpleNamespace(
        response=SimpleNamespace(error_code=error_code,
                                 error_text=error_text, retry_after_ms=0),
        attachment_size=0, compress_type=compress_type)


def _serialize_pb(request: Any, cntl: Controller) -> IOBuf:
    if request is None:
        return IOBuf()
    data = request.SerializeToString() if hasattr(request, "SerializeToString") \
        else bytes(request)
    if cntl.compress_type:
        data = compress_mod.compress(cntl.compress_type, data)
    return IOBuf(data)


def _run_method(server, cntl: Controller, md, data: bytes,
                respond) -> None:
    """Shared server tail: parse request, run user code, respond once."""
    try:
        request = md.request_cls()
        request.ParseFromString(data)
    except Exception as e:
        cntl.set_failed(errors.EREQUEST, f"fail to parse request: {e}")
        respond(None)
        return
    response = md.response_cls()
    fired = [False]

    def done() -> None:
        if fired[0]:
            return
        fired[0] = True
        respond(response)

    cntl.set_server_done(done)
    try:
        md.invoke(cntl, request, response, done)
    except Exception as e:
        log.error("method %s raised: %s", md.full_name, e, exc_info=True)
        if not fired[0]:
            cntl.set_failed(errors.EINTERNAL, f"{type(e).__name__}: {e}")
            done()


# ======================================================================
# hulu-pbrpc
# ======================================================================

def _pack_hulu(meta, payload: IOBuf) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(HULU_MAGIC)
    out.append((len(meta_bytes) + len(payload)).to_bytes(4, "little"))
    out.append(len(meta_bytes).to_bytes(4, "little"))
    out.append(meta_bytes)
    out.append(payload)
    return out


def hulu_parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    probe = source.fetch(min(len(source), 12))
    if probe is None:
        probe = b""
    if not HULU_MAGIC.startswith(probe[:4]):
        return ParseResult.try_others()
    if len(probe) < 12:
        return ParseResult.not_enough_data()
    body_size = int.from_bytes(probe[4:8], "little")
    meta_size = int.from_bytes(probe[8:12], "little")
    if body_size > (1 << 31):
        return ParseResult.parse_error("absurd hulu body_size")
    if len(source) < 12 + body_size:
        return ParseResult.not_enough_data()
    if meta_size > body_size:
        # recognized-but-invalid frame: fail the connection so the peer
        # sees the breakage (the contract of every magic-claimed parser)
        return ParseResult.parse_error(
            f"hulu meta_size {meta_size} > body_size {body_size}")
    source.pop_front(12)
    meta_buf = source.cut(meta_size)
    payload = source.cut(body_size - meta_size)
    return ParseResult.ok(_Frame(meta_buf.to_bytes(), payload))


def _hulu_find_method(server, meta: legacy_pb.HuluRequestMeta):
    if meta.method_name:
        return server.find_method(f"{meta.service_name}.{meta.method_name}")
    svc = server._services.get(meta.service_name)
    if svc is None:
        return None
    mds = list(svc.methods().values())       # name-sorted: the index space
    if 0 <= meta.method_index < len(mds):
        return server.find_method(mds[meta.method_index].full_name)
    return None


def hulu_process_request(frame: _Frame, socket, server) -> None:
    meta = legacy_pb.HuluRequestMeta()
    try:
        meta.ParseFromString(frame.meta)
    except Exception:
        socket.set_failed(errors.EREQUEST, "bad HuluRequestMeta")
        return
    cid = meta.correlation_id
    start_us = time.monotonic_ns() // 1000
    cntl = Controller()
    cntl.server = server
    cntl.log_id = meta.log_id
    cntl.remote_side = socket.remote_side
    cntl.compress_type = meta.compress_type
    from ..rpc.span import start_server_span, end_server_span
    start_server_span(cntl, f"{meta.service_name}#{meta.method_index}",
                      meta.trace_id, meta.span_id)
    md = _hulu_find_method(server, meta)
    status = server.method_status(md.full_name) if md is not None else None
    counted = [False]

    def respond(resp) -> None:
        rmeta = legacy_pb.HuluResponseMeta()
        rmeta.correlation_id = cid
        rmeta.error_code = cntl.error_code_
        if cntl.error_text_:
            rmeta.error_text = cntl.error_text_
        payload = IOBuf()
        if resp is not None and not cntl.failed():
            data = resp.SerializeToString()
            if meta.compress_type:
                data = compress_mod.compress(meta.compress_type, data)
                rmeta.compress_type = meta.compress_type
            payload.append(data)
        socket.write(_pack_hulu(rmeta, payload))
        if cntl.span is not None:
            end_server_span(cntl)
        if status is not None:
            status.on_responded(cntl.error_code_,
                                time.monotonic_ns() // 1000 - start_us)
        if counted[0]:
            server.on_request_out()

    if not server.on_request_in():
        cntl.set_failed(errors.ELIMIT, "server max_concurrency reached")
        respond(None)
        return
    counted[0] = True
    if md is None:
        cntl.set_failed(errors.ENOMETHOD,
                        f"no method {meta.service_name}#{meta.method_index}")
        respond(None)
        return
    if status is not None and not status.on_requested():
        cntl.set_failed(errors.ELIMIT, f"{md.full_name} concurrency limit")
        status = None
        respond(None)
        return
    data = frame.body.to_bytes()
    if meta.compress_type:
        try:
            data = compress_mod.decompress(meta.compress_type, data)
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"bad compressed body: {e}")
            respond(None)
            return
    _run_method(server, cntl, md, data, respond)


def hulu_process_response(frame: _Frame, socket) -> None:
    meta = legacy_pb.HuluResponseMeta()
    try:
        meta.ParseFromString(frame.meta)
    except Exception:
        return
    rc, cntl = bthread_id.lock(meta.correlation_id)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    cntl.handle_response(meta.correlation_id,
                         _resp_meta_shim(meta.error_code, meta.error_text,
                                         meta.compress_type),
                         frame.body)


def hulu_pack_request(payload: IOBuf, cid: int, cntl: Controller,
                      method_full_name: str) -> IOBuf:
    service, _, method_name = method_full_name.rpartition(".")
    meta = legacy_pb.HuluRequestMeta()
    meta.service_name = service
    meta.method_index = 0                  # method_name takes precedence
    meta.method_name = method_name
    meta.correlation_id = cid
    if cntl.log_id:
        meta.log_id = cntl.log_id
    if cntl.compress_type:
        meta.compress_type = cntl.compress_type
    if cntl.span is not None:
        meta.trace_id = cntl.span.trace_id
        meta.span_id = cntl.span.span_id
        meta.parent_span_id = cntl.span.parent_span_id
    return _pack_hulu(meta, payload)


# ======================================================================
# sofa-pbrpc
# ======================================================================

def _pack_sofa(meta: legacy_pb.SofaRpcMeta, payload: IOBuf) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(SOFA_MAGIC)
    out.append(len(meta_bytes).to_bytes(4, "little"))
    out.append(len(payload).to_bytes(8, "little"))
    out.append((len(meta_bytes) + len(payload)).to_bytes(8, "little"))
    out.append(meta_bytes)
    out.append(payload)
    return out


def sofa_parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    probe = source.fetch(min(len(source), 24))
    if probe is None:
        probe = b""
    if not SOFA_MAGIC.startswith(probe[:4]):
        return ParseResult.try_others()
    if len(probe) < 24:
        return ParseResult.not_enough_data()
    meta_size = int.from_bytes(probe[4:8], "little")
    body_size = int.from_bytes(probe[8:16], "little")
    total = int.from_bytes(probe[16:24], "little")
    if total != meta_size + body_size:
        return ParseResult.try_others()
    if body_size > (1 << 31):
        return ParseResult.parse_error("absurd sofa body_size")
    if len(source) < 24 + total:
        return ParseResult.not_enough_data()
    source.pop_front(24)
    meta_buf = source.cut(meta_size)
    payload = source.cut(body_size)
    meta = legacy_pb.SofaRpcMeta()
    try:
        meta.ParseFromString(meta_buf.to_bytes())
    except Exception as e:
        return ParseResult.parse_error(f"bad SofaRpcMeta: {e}")
    return ParseResult.ok(_Frame(meta, payload))


def sofa_process_request(frame: _Frame, socket, server) -> None:
    meta: legacy_pb.SofaRpcMeta = frame.meta
    if meta.type != legacy_pb.SofaRpcMeta.REQUEST:
        return                              # response on a server socket
    seq = meta.sequence_id
    start_us = time.monotonic_ns() // 1000
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = socket.remote_side
    cntl.compress_type = meta.compress_type
    md = server.find_method(meta.method)
    status = server.method_status(md.full_name) if md is not None else None
    counted = [False]

    def respond(resp) -> None:
        rmeta = legacy_pb.SofaRpcMeta()
        rmeta.type = legacy_pb.SofaRpcMeta.RESPONSE
        rmeta.sequence_id = seq
        if cntl.failed():
            rmeta.failed = True
            rmeta.error_code = cntl.error_code_
            rmeta.reason = cntl.error_text_
        payload = IOBuf()
        if resp is not None and not cntl.failed():
            data = resp.SerializeToString()
            want = meta.expected_response_compress_type or meta.compress_type
            if want:
                data = compress_mod.compress(want, data)
                rmeta.compress_type = want
            payload.append(data)
        socket.write(_pack_sofa(rmeta, payload))
        if status is not None:
            status.on_responded(cntl.error_code_,
                                time.monotonic_ns() // 1000 - start_us)
        if counted[0]:
            server.on_request_out()

    if not server.on_request_in():
        cntl.set_failed(errors.ELIMIT, "server max_concurrency reached")
        respond(None)
        return
    counted[0] = True
    if md is None:
        cntl.set_failed(errors.ENOMETHOD, f"no method {meta.method}")
        respond(None)
        return
    if status is not None and not status.on_requested():
        cntl.set_failed(errors.ELIMIT, f"{md.full_name} concurrency limit")
        status = None
        respond(None)
        return
    data = frame.body.to_bytes()
    if meta.compress_type:
        try:
            data = compress_mod.decompress(meta.compress_type, data)
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"bad compressed body: {e}")
            respond(None)
            return
    _run_method(server, cntl, md, data, respond)


def sofa_process_response(frame: _Frame, socket) -> None:
    meta: legacy_pb.SofaRpcMeta = frame.meta
    if meta.type != legacy_pb.SofaRpcMeta.RESPONSE:
        return
    rc, cntl = bthread_id.lock(meta.sequence_id)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    err = meta.error_code if meta.failed else 0
    if meta.failed and err == 0:
        err = errors.EINTERNAL
    cntl.handle_response(meta.sequence_id,
                         _resp_meta_shim(err, meta.reason,
                                         meta.compress_type),
                         frame.body)


def sofa_pack_request(payload: IOBuf, cid: int, cntl: Controller,
                      method_full_name: str) -> IOBuf:
    meta = legacy_pb.SofaRpcMeta()
    meta.type = legacy_pb.SofaRpcMeta.REQUEST
    meta.sequence_id = cid
    meta.method = method_full_name
    if cntl.compress_type:
        meta.compress_type = cntl.compress_type
    return _pack_sofa(meta, payload)


HULU_PROTOCOL = Protocol(
    name="hulu_pbrpc",
    parse=hulu_parse,
    process_request=hulu_process_request,
    process_response=hulu_process_response,
    serialize_request=_serialize_pb,
    pack_request=hulu_pack_request,
)

SOFA_PROTOCOL = Protocol(
    name="sofa_pbrpc",
    parse=sofa_parse,
    process_request=sofa_process_request,
    process_response=sofa_process_response,
    serialize_request=_serialize_pb,
    pack_request=sofa_pack_request,
)


def _register() -> None:
    if find_protocol("hulu_pbrpc") is None:
        register_protocol(HULU_PROTOCOL)
    if find_protocol("sofa_pbrpc") is None:
        register_protocol(SOFA_PROTOCOL)


_register()
