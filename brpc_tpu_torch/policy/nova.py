"""nova-pbrpc: nshead-framed protobuf protocol (method index in the head).

Reference behavior: src/brpc/policy/nova_pbrpc_protocol.cpp — requests are
an nshead whose `reserved` field carries the method index and whose body is
the serialized pb request; responses are an nshead + serialized pb
response.  No correlation id on the wire → pooled/short connections only
(PackNovaRequest rejects CONNECTION_TYPE_SINGLE and stashes the id on the
socket; here the id rides the per-call pipeline context).  The server side
is an NsheadPbServiceAdaptor (NovaServiceAdaptor).

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/nova.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations


from ..butil.iobuf import IOBuf
from ..bthread import id as bthread_id
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import (CONNECTION_TYPE_POOLED, CONNECTION_TYPE_SHORT,
                            Protocol, ParseResult, register_protocol,
                            find_protocol)
from .nshead import (NsheadCallCtx, NsheadHead, NsheadMessage,
                     NsheadPbServiceAdaptor)
from .legacy_pbrpc import _resp_meta_shim, _serialize_pb


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    head = NsheadHead()
    head.log_id = cntl.log_id
    head.reserved = getattr(cntl, "method_index", 0) or 0
    head.body_len = len(payload)
    out = IOBuf()
    out.append(head.pack())
    out.append(payload)
    return out


def _complete(msg: NsheadMessage, socket, ctx: NsheadCallCtx) -> None:
    rc, cntl = bthread_id.lock(ctx.cid)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    cntl.handle_response(ctx.cid, _resp_meta_shim(0, "", 0), msg.body)


def make_pipeline_ctx(cid: int, cntl: Controller) -> NsheadCallCtx:
    return NsheadCallCtx(cid, _complete, "nova_pbrpc")


class NovaServiceAdaptor(NsheadPbServiceAdaptor):
    """Dispatch nshead.reserved as an index into `service_name`'s methods
    (name-sorted, the service's stable index space)."""

    def __init__(self, service_name: str):
        self.target_service = service_name

    def parse_nshead_meta(self, server, request, controller, meta) -> None:
        svc = server._services.get(self.target_service)
        if svc is None:
            controller.set_failed(errors.ENOSERVICE,
                                  f"no service {self.target_service}")
            return
        mds = list(svc.methods().values())
        idx = request.head.reserved
        if not (0 <= idx < len(mds)):
            controller.set_failed(errors.ENOMETHOD,
                                  f"bad method index {idx}")
            return
        meta.full_method_name = mds[idx].full_name
        meta.log_id = request.head.log_id

    def parse_request_from_iobuf(self, meta, request, controller,
                                 pb_req) -> None:
        try:
            pb_req.ParseFromString(request.body.to_bytes())
        except Exception as e:
            controller.set_failed(errors.EREQUEST,
                                  f"fail to parse request: {e}")

    def serialize_response_to_iobuf(self, meta, controller, pb_res,
                                    response) -> None:
        if not controller.failed() and pb_res is not None:
            response.body.append(pb_res.SerializeToString())


# parse never claims bytes: the shared `nshead` protocol cuts the frames
# and completes through the pipeline context installed above.
PROTOCOL = Protocol(
    name="nova_pbrpc",
    parse=lambda source, socket, read_eof, arg: ParseResult.try_others(),
    serialize_request=_serialize_pb,
    pack_request=pack_request,
    supported_connection_type=CONNECTION_TYPE_POOLED | CONNECTION_TYPE_SHORT,
    support_server=False,
    pipelined=True,
    make_pipeline_ctx=make_pipeline_ctx,
)


if find_protocol("nova_pbrpc") is None:
    register_protocol(PROTOCOL)
