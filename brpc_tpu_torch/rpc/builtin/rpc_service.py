"""The builtin pages as RPC methods, ported from
:mod:`brpc_tpu.rpc.builtin.rpc_service`.

Two services are mounted on every server with builtin services enabled
(``ServerOptions.enable_builtin_services``, default True):

  * ``brpc_tpu.Trace`` — ``FindTrace``/``ListRecent`` answer from this
    process's span store (:mod:`..span`) with the responder's process id
    and wall clock, so a peer can stitch the spans into its own timeline
    (:mod:`.pod_scope`);
  * ``brpc_tpu.Builtin`` — ``Call(page, query)`` dispatches any builtin
    page through the server's :class:`~.services.BuiltinDispatcher`.

Messages are :class:`JsonMsg`: JSON bytes behind the protobuf surface the
protocol needs (``SerializeToString``/``ParseFromString``), so the services
ride tpu_std over ``mem://`` and ``ici://`` unchanged, byte for byte as the
JAX package's do.  A server that wants no admin surface sets
``enable_builtin_services=False``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

from ..service import Service, method
from .. import errors


class JsonMsg:
    """A JSON-carried message with the protobuf wire surface; its fields
    live in ``.fields``."""

    def __init__(self, **fields: Any):
        self.fields: Dict[str, Any] = dict(fields)

    def SerializeToString(self) -> bytes:
        return json.dumps(self.fields).encode()

    def ParseFromString(self, data: bytes) -> None:
        self.fields = json.loads(data.decode()) if data else {}

    def get(self, key: str, default: Any = None) -> Any:
        return self.fields.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self.fields[key]

    def __repr__(self) -> str:
        return f"JsonMsg({self.fields!r})"


def local_pid() -> int:
    """This process's fabric process id (the pod's member id); -1 in a
    process with no fabric node."""
    try:
        from ...ici.fabric import FabricNode
        node = FabricNode.instance()
        return node.process_id if node is not None else -1
    except Exception:
        return -1


class TraceService(Service):
    """find_trace and list-recent over this process's span store
    (builtin/rpcz_service.cpp's query surface)."""

    SERVICE_NAME = "brpc_tpu.Trace"

    @method(JsonMsg, JsonMsg)
    def FindTrace(self, cntl, request, response, done):
        from ..span import find_trace
        try:
            tid = int(str(request.get("trace_id", "0")), 16)
        except ValueError:
            cntl.set_failed(errors.EREQUEST, "trace_id must be hex")
            done()
            return
        response.fields = {
            "pid": local_pid(),
            "os_pid": os.getpid(),
            "wall_us": time.time_ns() // 1000,
            "spans": [s.describe() for s in find_trace(tid)],
        }
        done()

    @method(JsonMsg, JsonMsg)
    def ListRecent(self, cntl, request, response, done):
        from ..span import recent_spans
        limit = int(request.get("limit", 100))
        response.fields = {
            "pid": local_pid(),
            "os_pid": os.getpid(),
            "wall_us": time.time_ns() // 1000,
            "spans": [s.describe() for s in recent_spans(limit)],
        }
        done()


class BuiltinRpcService(Service):
    """Any builtin page as an RPC: ``Call({page, query})`` → ``{status,
    content_type, body, pid}``."""

    SERVICE_NAME = "brpc_tpu.Builtin"

    @method(JsonMsg, JsonMsg)
    def Call(self, cntl, request, response, done):
        server = cntl.server
        builtin = getattr(server, "_builtin", None) \
            if server is not None else None
        if builtin is None:
            cntl.set_failed(errors.ENOSERVICE, "no builtin dispatcher")
            done()
            return
        page = str(request.get("page", ""))
        query = request.get("query") or {}
        hit = builtin.dispatch(page, {str(k): str(v)
                                      for k, v in query.items()})
        if hit is None:
            response.fields = {"status": 404, "content_type": "text/plain",
                               "body": f"no builtin page {page!r}",
                               "pid": local_pid()}
            done()
            return
        status, (ctype, body) = (200, hit) if len(hit) == 2 \
            else (hit[0], hit[1:])
        response.fields = {"status": status, "content_type": ctype,
                           "body": body, "pid": local_pid()}
        done()
