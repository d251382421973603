"""public-pbrpc: nshead(version=1000) frames carrying one pb envelope.

Reference behavior: src/brpc/policy/public_pbrpc_protocol.cpp — the whole
nshead body is a single PublicRequest/PublicResponse message; the request
body list carries (service, method_id, id=correlation id, serialized
request), the response echoes the id, and errors ride responseHead.code.
Unlike nova, the correlation id IS on the wire, but frames still share the
nshead magic, so cutting stays with the shared `nshead` protocol and the
per-call context double-checks the echoed id.  Server side is an
NsheadPbServiceAdaptor registered like any nshead service.

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/public_pbrpc.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

import re

from ..butil.iobuf import IOBuf
from ..bthread import id as bthread_id
from ..proto import legacy_meta_pb2 as legacy_pb
from ..rpc import errors
from ..rpc import compress as compress_mod
from ..rpc.controller import Controller
from ..rpc.protocol import (CONNECTION_TYPE_POOLED, CONNECTION_TYPE_SHORT,
                            Protocol, ParseResult, register_protocol,
                            find_protocol)
from .nshead import (NsheadCallCtx, NsheadHead, NsheadMessage,
                     NsheadPbServiceAdaptor)
from .legacy_pbrpc import _resp_meta_shim, _serialize_pb

NSHEAD_VERSION = 1000
PROVIDER = b"pbrpc"
_VERSIONISH = re.compile(r"[0-9.]*")


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    service, _, method_name = method_full_name.rpartition(".")
    env = legacy_pb.PublicRequest()
    env.requestHead.log_id = cntl.log_id
    if cntl.compress_type:
        env.requestHead.compress_type = cntl.compress_type
    body = env.requestBody.add()
    body.service = service
    body.method_id = getattr(cntl, "method_index", 0) or 0
    body.id = cid
    # carry the method name in `version` so name dispatch also works
    # (method_id stays authoritative for reference-shaped peers)
    body.version = method_name
    body.serialized_request = payload.to_bytes()
    data = env.SerializeToString()
    head = NsheadHead(version=NSHEAD_VERSION, provider=PROVIDER,
                      log_id=cntl.log_id, body_len=len(data))
    out = IOBuf()
    out.append(head.pack())
    out.append(data)
    return out


def _complete(msg: NsheadMessage, socket, ctx: NsheadCallCtx) -> None:
    rc, cntl = bthread_id.lock(ctx.cid)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    env = legacy_pb.PublicResponse()
    try:
        env.ParseFromString(msg.body.to_bytes())
    except Exception as e:
        cntl.set_failed(errors.ERESPONSE, f"bad PublicResponse: {e}")
        cntl.finish_parsed_response(ctx.cid)
        return
    code = env.responseHead.code if env.HasField("responseHead") else 0
    text = env.responseHead.text if env.HasField("responseHead") else ""
    payload = IOBuf()
    if env.responseBody:
        rb = env.responseBody[0]
        if rb.id != ctx.cid:
            cntl.set_failed(errors.ERESPONSE,
                            f"response id {rb.id} != call id {ctx.cid}")
            cntl.finish_parsed_response(ctx.cid)
            return
        if rb.error and code == 0:
            code = rb.error
        payload.append(rb.serialized_response)
    cntl.handle_response(
        ctx.cid, _resp_meta_shim(code, text,
                                 env.responseHead.compress_type), payload)


def make_pipeline_ctx(cid: int, cntl: Controller) -> NsheadCallCtx:
    return NsheadCallCtx(cid, _complete, "public_pbrpc")


class PublicPbrpcServiceAdaptor(NsheadPbServiceAdaptor):
    """The server half: unwrap PublicRequest, dispatch by (service,
    method_id|method name), wrap the reply in PublicResponse."""

    def parse_nshead_meta(self, server, request, controller, meta) -> None:
        if request.head.version != NSHEAD_VERSION:
            controller.set_failed(errors.EREQUEST,
                                  f"bad nshead version {request.head.version}")
            return
        env = legacy_pb.PublicRequest()
        try:
            env.ParseFromString(request.body.to_bytes())
        except Exception as e:
            controller.set_failed(errors.EREQUEST, f"bad PublicRequest: {e}")
            return
        if not env.requestBody:
            controller.set_failed(errors.EREQUEST, "empty requestBody")
            return
        rb = env.requestBody[0]
        # record the envelope identity FIRST: failure responses must still
        # echo the caller's correlation id
        meta.correlation_id = rb.id
        meta.log_id = env.requestHead.log_id
        meta.compress_type = env.requestHead.compress_type
        svc = server._services.get(rb.service)
        if svc is None:
            controller.set_failed(errors.ENOSERVICE,
                                  f"no service {rb.service}")
            return
        # `version` is a version string for reference-shaped peers
        # ("1.0.0"); our client repurposes it to carry the method name.
        # A name-like version that matches no method is a typo'd method,
        # not an invitation to fall back to method_id 0.
        name_like = bool(rb.version) and not _VERSIONISH.fullmatch(rb.version)
        if name_like:
            full = f"{rb.service}.{rb.version}"
            if server.find_method(full) is None:
                controller.set_failed(errors.ENOMETHOD, f"no method {full}")
                return
            meta.full_method_name = full
        else:
            mds = list(svc.methods().values())
            if not (0 <= rb.method_id < len(mds)):
                controller.set_failed(errors.ENOMETHOD,
                                      f"bad method_id {rb.method_id}")
                return
            meta.full_method_name = mds[rb.method_id].full_name
        controller._public_serialized = rb.serialized_request

    def parse_request_from_iobuf(self, meta, request, controller,
                                 pb_req) -> None:
        data = getattr(controller, "_public_serialized", b"")
        try:
            if meta.compress_type:
                data = compress_mod.decompress(meta.compress_type, data)
            pb_req.ParseFromString(data)
        except Exception as e:
            controller.set_failed(errors.EREQUEST,
                                  f"fail to parse request: {e}")

    def serialize_response_to_iobuf(self, meta, controller, pb_res,
                                    response) -> None:
        env = legacy_pb.PublicResponse()
        env.responseHead.code = controller.error_code_
        if controller.error_text_:
            env.responseHead.text = controller.error_text_
        rb = env.responseBody.add()
        rb.id = meta.correlation_id
        if controller.failed():
            rb.error = controller.error_code_
        elif pb_res is not None:
            rb.serialized_response = pb_res.SerializeToString()
        response.head.version = NSHEAD_VERSION
        response.head.provider = PROVIDER
        response.body.append(env.SerializeToString())


PROTOCOL = Protocol(
    name="public_pbrpc",
    parse=lambda source, socket, read_eof, arg: ParseResult.try_others(),
    serialize_request=_serialize_pb,
    pack_request=pack_request,
    supported_connection_type=CONNECTION_TYPE_POOLED | CONNECTION_TYPE_SHORT,
    support_server=False,
    pipelined=True,
    make_pipeline_ctx=make_pipeline_ctx,
)


if find_protocol("public_pbrpc") is None:
    register_protocol(PROTOCOL)
