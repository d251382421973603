"""ubrpc: nshead frames whose body is an mcpack envelope (UB ecosystem).

Reference behavior: src/brpc/policy/ubrpc2pb_protocol.cpp — the request
body is one mcpack object {content: [{service_name, method, id, params:
{...}}]}; `params` with a single field means that field's value is the
user request (idl wrapper convention), otherwise params itself is.  The
response is {content: [{id, result?, result_params: {...}}]} on success
or {content: [{id, error: {code, message}}]} on failure.  The reference
registers two variants differing only in serialization format
(compack / mcpack_v2); our peers speak mcpack_v2, and `ubrpc_compack` is
registered as an alias of the same wire so reference-shaped call sites
keep working (compack itself is a Baidu-internal sibling format with no
public speakers).

Server side is an NsheadPbServiceAdaptor (UbrpcAdaptor); client rides
the shared nshead cutter through per-call pipeline contexts, verifying
the echoed `id`.

The wire bytes and the parser's verdicts are those of the JAX
package's ``policy/ubrpc.py``, so either package's client talks to the
other's server.
"""
from __future__ import annotations

from typing import Any

from ..butil.iobuf import IOBuf
from ..bthread import id as bthread_id
from ..codec.mcpack import (mcpack_encode, mcpack_decode, pb_to_dict,
                            dict_to_pb)
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import (CONNECTION_TYPE_POOLED, CONNECTION_TYPE_SHORT,
                            Protocol, ParseResult, register_protocol,
                            find_protocol)
from .nshead import NsheadCallCtx, NsheadHead, NsheadMessage, \
    NsheadPbServiceAdaptor


def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    # stash the pb; the envelope needs the method identity at pack time
    cntl._ubrpc_request = request
    return IOBuf()


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str, _compack: bool = False) -> IOBuf:
    service, _, method_name = method_full_name.rpartition(".")
    request = getattr(cntl, "_ubrpc_request", None)
    params = pb_to_dict(request) if request is not None else {}
    envelope = {
        "content": [{
            "service_name": service,
            "method": method_name,
            "id": cid,
            # single-field params: the value is the user request (the
            # reference's idl-wrapper convention)
            "params": {"req": params},
        }],
    }
    data = mcpack_encode(envelope, compack=_compack)
    head = NsheadHead(log_id=cntl.log_id, body_len=len(data))
    out = IOBuf()
    out.append(head.pack())
    out.append(data)
    return out


def _complete(msg: NsheadMessage, socket, ctx: NsheadCallCtx) -> None:
    rc, cntl = bthread_id.lock(ctx.cid)
    if rc != 0 or cntl is None:
        return
    cntl.remote_side = socket.remote_side
    # EVERYTHING between lock and finish runs under one exception guard:
    # an uncaught raise here would leave the correlation id locked and the
    # caller blocked forever (the messenger only logs handler exceptions)
    try:
        envelope = mcpack_decode(msg.body.to_bytes())
        content = envelope.get("content") or []
        item = content[0] if content else {}
        if not isinstance(item, dict):
            raise ValueError("content[0] is not an object")
        got_id = item.get("id")
        err = item.get("error")
        if isinstance(err, dict):
            cntl.set_failed(int(err.get("code") or errors.EINTERNAL),
                            str(err.get("message") or "ubrpc error"))
        elif got_id is not None and got_id != ctx.cid:
            cntl.set_failed(errors.ERESPONSE,
                            f"response id {got_id} != call id {ctx.cid}")
        else:
            if "result" in item:
                cntl.idl_result = item["result"]
            rp = item.get("result_params") or {}
            # single-field wrapper unwraps to the response object
            if isinstance(rp, dict) and len(rp) == 1:
                (only,) = rp.values()
                if isinstance(only, dict):
                    rp = only
            if cntl._response_cls is not None:
                cntl.response = dict_to_pb(rp, cntl._response_cls())
            else:
                cntl.response = rp
    except Exception as e:
        cntl.set_failed(errors.ERESPONSE, f"bad ubrpc response: {e}")
    cntl.finish_parsed_response(ctx.cid)


def make_pipeline_ctx(cid: int, cntl: Controller) -> NsheadCallCtx:
    return NsheadCallCtx(cid, _complete, "ubrpc")


class UbrpcAdaptor(NsheadPbServiceAdaptor):
    """Server half: unwrap the mcpack envelope, dispatch by
    service_name.method, wrap the pb reply (or the error) back."""

    def parse_nshead_meta(self, server, request, controller, meta) -> None:
        try:
            envelope = mcpack_decode(request.body.to_bytes())
        except Exception as e:
            controller.set_failed(errors.EREQUEST,
                                  f"request is not mcpack: {e}")
            return
        content = envelope.get("content")
        if not isinstance(content, list) or not content \
                or not isinstance(content[0], dict):
            controller.set_failed(errors.EREQUEST,
                                  "fail to find request.content")
            return
        item = content[0]
        # record the envelope identity FIRST: failure responses must still
        # echo the caller's correlation id
        if isinstance(item.get("id"), int):
            meta.correlation_id = item["id"]
        meta.log_id = request.head.log_id
        service_name = item.get("service_name")
        method_name = item.get("method")
        if not isinstance(service_name, str) or \
                not isinstance(method_name, str) or \
                not service_name or not method_name:
            controller.set_failed(
                errors.EREQUEST, "missing content[0].service_name/method")
            return
        if "params" not in item:
            controller.set_failed(errors.EREQUEST,
                                  "fail to find content[0].params")
            return
        params = item["params"]
        if not isinstance(params, dict) or not params:
            controller.set_failed(errors.EREQUEST,
                                  "content[0].params must be a non-empty "
                                  "object")
            return
        if len(params) == 1:
            (only,) = params.values()
            if isinstance(only, dict):
                params = only
        controller._ubrpc_params = params
        meta.full_method_name = f"{service_name}.{method_name}"

    def parse_request_from_iobuf(self, meta, request, controller,
                                 pb_req) -> None:
        try:
            dict_to_pb(getattr(controller, "_ubrpc_params", {}), pb_req)
        except Exception as e:
            controller.set_failed(errors.EREQUEST,
                                  f"fail to map params: {e}")

    def serialize_response_to_iobuf(self, meta, controller, pb_res,
                                    response) -> None:
        item: dict = {"id": meta.correlation_id}
        if controller.failed() or pb_res is None:
            item["error"] = {"code": controller.error_code_
                             or errors.EINTERNAL,
                             "message": controller.error_text_ or "failed"}
        else:
            idl_result = getattr(controller, "idl_result", None)
            if idl_result is not None:
                item["result"] = idl_result
            item["result_params"] = {"res": pb_to_dict(pb_res)}
        response.body.append(mcpack_encode({"content": [item]}))


def _never_parse(source, socket, read_eof, arg):
    return ParseResult.try_others()


UBRPC_MCPACK2 = Protocol(
    name="ubrpc_mcpack2",
    parse=_never_parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    supported_connection_type=CONNECTION_TYPE_POOLED | CONNECTION_TYPE_SHORT,
    support_server=False,
    pipelined=True,
    make_pipeline_ctx=make_pipeline_ctx,
)

def pack_request_compack(payload: IOBuf, cid: int, cntl: Controller,
                         method_full_name: str) -> IOBuf:
    """FORMAT_COMPACK wire (ubrpc2pb_protocol.cpp:530): same envelope,
    primitive arrays serialized as isoarrays."""
    return pack_request(payload, cid, cntl, method_full_name,
                        _compack=True)


UBRPC_COMPACK = Protocol(
    name="ubrpc_compack",
    parse=_never_parse,
    serialize_request=serialize_request,
    pack_request=pack_request_compack,
    supported_connection_type=CONNECTION_TYPE_POOLED | CONNECTION_TYPE_SHORT,
    support_server=False,
    pipelined=True,
    make_pipeline_ctx=make_pipeline_ctx,
)


if find_protocol("ubrpc_mcpack2") is None:
    register_protocol(UBRPC_MCPACK2)
if find_protocol("ubrpc_compack") is None:
    register_protocol(UBRPC_COMPACK)
