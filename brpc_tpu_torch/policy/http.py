"""HTTP/1.1 protocol: JSON access to pb services + the builtin admin pages.

Reference: src/brpc/policy/http_rpc_protocol.cpp (+ details/http_parser,
http_message) — the same server port speaks HTTP next to tpu_std thanks to
protocol detection (text method prefix vs "TRPC" magic).  The parser,
the dispatch order and the bytes each side writes are those of the JAX
package's ``policy/http.py``, so either package's client talks to the
other's server.  Routes:

  * ``POST /ServiceName/MethodName`` with a JSON body → the pb method
    (json2pb both ways), mirroring the reference's /Service/Method mapping.
  * ``GET /status|/vars|/flags|/connections|/rpcz|/brpc_metrics|...`` →
    builtin admin pages (builtin/services.py).
  * anything else → 404.

Client side: ``Channel.init(..., options=ChannelOptions(protocol="http"))``
issues HTTP requests with pb-JSON bodies and parses responses, completing
the same Controller machinery (correlation by pipeline order — HTTP/1.1 on
one connection answers in order, the reference's behavior without h2).
Both ends keep that order across the concurrent per-message dispatch: a
response claims its call's context in the reader, in arrival order
(``process_inline``), and a server numbers each connection's requests
there and writes their responses in that order, whichever handler
finishes first.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional

from ..butil.containers import CaseIgnoredFlatMap
from ..butil.iobuf import IOBuf
from ..codec import json2pb
from ..proto import rpc_meta_pb2 as meta_pb
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import Protocol, ParseResult, register_protocol

_METHODS = (b"GET ", b"POST", b"PUT ", b"DELE", b"HEAD", b"OPTI", b"PATC",
            b"HTTP")


class HttpMessage:
    def __init__(self):
        self.is_request = True
        self.method = "GET"
        self.path = "/"
        self.query: Dict[str, str] = {}
        self.status = 200
        self.reason = "OK"
        self.headers: CaseIgnoredFlatMap = CaseIgnoredFlatMap()
        self.body = b""
        # client: the call context this response answers; server: the
        # request's place in its connection's order (process_inline)
        self.pipeline_ctx = None
        self.seq: Optional[int] = None


def _parse_http(source: IOBuf) -> ParseResult:
    head = source.fetch(4)
    if head is None:
        return ParseResult.not_enough_data()
    if not any(head == m[:len(head)] or head.startswith(m.strip())
               for m in _METHODS):
        return ParseResult.try_others()
    data = source.fetch(len(source))
    sep = data.find(b"\r\n\r\n")
    if sep < 0:
        if len(data) > 1 << 20:
            return ParseResult.parse_error("header too large")
        return ParseResult.not_enough_data()
    header_bytes = data[:sep]
    lines = header_bytes.split(b"\r\n")
    msg = HttpMessage()
    first = lines[0].decode("latin1")
    parts = first.split(" ")
    if first.startswith("HTTP/"):
        msg.is_request = False
        msg.status = int(parts[1])
        msg.reason = " ".join(parts[2:]) if len(parts) > 2 else ""
    else:
        msg.is_request = True
        msg.method = parts[0]
        target = parts[1] if len(parts) > 1 else "/"
        parsed = urllib.parse.urlsplit(target)
        msg.path = parsed.path
        msg.query = dict(urllib.parse.parse_qsl(parsed.query))
    for line in lines[1:]:
        k, _, v = line.decode("latin1").partition(":")
        msg.headers[k.strip()] = v.strip()
    te = msg.headers.get("Transfer-Encoding", "")
    if te:
        # RFC 7230 §4.1 chunked coding, both directions (requests from
        # curl-style clients that stream bodies of unknown length, and
        # responses from chunked-emitting servers).  Token-exact: 'gzip, chunked' (a
        # coding we cannot decode) or 'xchunked' must be REJECTED, not
        # substring-matched into ambiguous framing (§3.3.3 — the
        # smuggling shape), and chunked combined with anything else is
        # unsupported here.
        tokens = [t.strip().lower() for t in te.split(",") if t.strip()]
        if tokens != ["chunked"]:
            return ParseResult.parse_error(
                f"unsupported transfer-encoding {te!r}")
        body, total = _parse_chunked_body(data, sep + 4)
        if total < 0:
            return ParseResult.parse_error("bad chunked framing")
        if body is None:
            return ParseResult.not_enough_data()
        msg.body = body
        source.pop_front(total)
        return ParseResult.ok(msg)
    length = int(msg.headers.get("Content-Length", "0") or 0)
    total = sep + 4 + length
    if len(data) < total:
        return ParseResult.not_enough_data()
    msg.body = data[sep + 4:total]
    source.pop_front(total)
    return ParseResult.ok(msg)


def _parse_chunked_body(data: bytes, off: int):
    """Decode a chunked body starting at ``off``.  Returns
    ``(body, total_consumed)``; ``(None, 0)`` when incomplete;
    ``(None, -1)`` on malformed framing.  Trailer headers (RFC 7230
    §4.1.2) are consumed and discarded."""
    out = []
    while True:
        nl = data.find(b"\r\n", off)
        if nl < 0:
            return None, 0
        size_token = data[off:nl].split(b";", 1)[0].strip()  # drop ext
        # pure-hex only: int(x, 16) would also accept '-2' / '+5' /
        # '0x10' / '1_0', and a negative size desyncs framing against
        # any strict RFC 7230 peer — the request-smuggling shape
        if not size_token or any(c not in b"0123456789abcdefABCDEF"
                                 for c in size_token):
            return None, -1
        size = int(size_token, 16)
        off = nl + 2
        if size == 0:
            break
        if len(data) < off + size + 2:
            return None, 0
        out.append(data[off:off + size])
        if data[off + size:off + size + 2] != b"\r\n":
            return None, -1
        off += size + 2
    # trailer section: zero or more header lines, then the empty line
    while True:
        nl = data.find(b"\r\n", off)
        if nl < 0:
            return None, 0
        if nl == off:                      # empty line: body complete
            return b"".join(out), nl + 2
        off = nl + 2


def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    return _parse_http(source)


def _render_response(status: int, body: bytes, content_type: str,
                     extra_headers: Optional[Dict[str, str]] = None,
                     chunked: bool = False) -> IOBuf:
    reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
              403: "Forbidden", 404: "Not Found",
              500: "Internal Server Error", 503: "Service Unavailable"}.get(
                  status, "OK")
    out = IOBuf()
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}"]
    if chunked:
        head.append("Transfer-Encoding: chunked")
    else:
        head.append(f"Content-Length: {len(body)}")
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    out.append(("\r\n".join(head) + "\r\n\r\n").encode())
    if chunked:
        out.append(_encode_chunked(body))
    else:
        out.append(body)
    return out


def _encode_chunked(body: bytes) -> bytes:
    """RFC 7230 §4.1 chunked framing.  The body is split into at least
    two chunks when possible so receivers exercise real re-assembly, not
    the one-chunk degenerate case."""
    chunks = []
    if len(body) > 1:
        half = len(body) // 2
        chunks = [body[:half], body[half:]]
    elif body:
        chunks = [body]
    out = []
    for c in chunks:
        out.append(b"%x\r\n" % len(c))
        out.append(c)
        out.append(b"\r\n")
    out.append(b"0\r\n\r\n")
    return b"".join(out)


# ---- server side ------------------------------------------------------

class _InOrder:
    """A request's socket whose ``write`` holds the response until every
    earlier request of the connection has been answered (HTTP/1.1
    pipelining: responses leave in request order)."""

    __slots__ = ("_sock", "_seq")

    def __init__(self, sock, seq: int):
        self._sock = sock
        self._seq = seq

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def write(self, buf: IOBuf, **kw) -> int:
        sock = self._sock
        lock, pending = sock._http_order
        rc = 0
        with lock:
            pending[self._seq] = buf
            # the lock spans the writes: two handlers finishing at once
            # must not interleave their turns
            while sock._http_next_out in pending:
                out = pending.pop(sock._http_next_out)
                sock._http_next_out += 1
                rc = sock.write(out) or rc
        return rc


def process_request(msg: HttpMessage, socket, server) -> None:
    if msg.seq is None:
        _process_request(msg, socket, server)
        return
    out = _InOrder(socket, msg.seq)
    try:
        _process_request(msg, out, server)
    except Exception as e:
        # every numbered request answers once, or its connection's later
        # responses would wait behind it forever
        out.write(_render_response(
            500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
            "application/json"))
        raise


def _process_request(msg: HttpMessage, socket, server) -> None:
    start_us = time.monotonic_ns() // 1000
    path = msg.path.strip("/")
    internal_conn = getattr(socket, "internal_only", False)
    # 1) builtin pages.  With ServerOptions.internal_port set, admin
    # pages move to THAT port exclusively (reference server.h
    # internal_port: "only accessible from internal_port") — the public
    # port refuses them, and the internal port serves nothing else.
    builtin = getattr(server, "_builtin", None)
    if builtin is not None:
        admin_here = internal_conn or server.options.internal_port < 0
        if admin_here:
            hit = builtin.dispatch(path or "index", dict(msg.query))
            if hit is not None:
                # 2-tuple = 200; 3-tuple carries an explicit status
                # (/health → 503 while draining)
                status, (ctype, body) = (200, hit) if len(hit) == 2 \
                    else (hit[0], hit[1:])
                socket.write(_render_response(status, body.encode(), ctype))
                return
        elif (path or "index") in builtin.handlers:
            # dispatch() can have side effects (/flags, /vlog): refuse by
            # path membership, never by probing
            socket.write(_render_response(
                403, b'{"error":"builtin services are only served on '
                     b'the internal port"}', "application/json"))
            return
    if internal_conn:
        # the admin port serves ONLY builtin pages
        socket.write(_render_response(
            403, b'{"error":"user services are not served on the '
                 b'internal port"}', "application/json"))
        return
    # 2) restful mappings (reference restful.{h,cpp})
    mapped = server.options.restful_mappings.get("/" + path)
    if mapped is not None:
        md = server.find_method(mapped)
        if md is not None:
            _process_json_rpc(msg, socket, server, md, mapped, start_us)
            return
    # 3) /Service/Method JSON RPC
    parts = [p for p in path.split("/") if p]
    if len(parts) == 2:
        full_name = f"{parts[0]}.{parts[1]}"
        md = server.find_method(full_name)
        if md is not None:
            _process_json_rpc(msg, socket, server, md, full_name, start_us)
            return
    socket.write(_render_response(
        404, json.dumps({"error": f"no handler for /{path}"}).encode(),
        "application/json"))


def json_rpc_dispatch(server, md, full_name: str, body: str, send,
                      start_us: int, cntl: Optional[Controller] = None
                      ) -> None:
    """JSON-RPC dispatch shared by HTTP/1 and h2 REST (policy/grpc.py):
    method-status accounting, json2pb both directions, and the error-JSON
    shapes, with ``send(code, body_bytes)`` as the transport-specific
    responder.  ``send`` is called exactly once."""
    if cntl is None:
        cntl = Controller()
    cntl.server = server
    if getattr(server, "is_draining", lambda: False)():
        # lame-duck: same contract as tpu_std — the rpc-aware http
        # client maps the code back to retryable ELOGOFF and fails over
        send(503, json.dumps({"error": "server is draining (lame duck)",
                              "code": errors.ELOGOFF}).encode())
        return
    status = server.method_status(full_name)
    if status is not None and not status.on_requested():
        send(503, b'{"error":"concurrency limit"}')
        return

    def finish(code: int, body_bytes: bytes) -> None:
        send(code, body_bytes)
        if status is not None:
            status.on_responded(0 if code == 200 else code,
                                time.monotonic_ns() // 1000 - start_us)

    ok, request, err = json2pb.json_to_pb(body, md.request_cls)
    if not ok:
        finish(400, json.dumps({"error": f"bad request JSON: {err}"}).encode())
        return
    response = md.response_cls()
    done_called = [False]

    def done() -> None:
        if done_called[0]:
            return
        done_called[0] = True
        if cntl.failed():
            finish(500, json.dumps({"error": cntl.error_text_,
                                    "code": cntl.error_code_}).encode())
        else:
            ok2, js = json2pb.pb_to_json(response)
            finish(200 if ok2 else 500, js.encode())

    cntl.set_server_done(done)
    try:
        md.invoke(cntl, request, response, done)
    except Exception as e:
        if not done_called[0]:
            cntl.set_failed(errors.EINTERNAL, f"{type(e).__name__}: {e}")
            done()


def _process_json_rpc(msg: HttpMessage, socket, server, md, full_name,
                      start_us) -> None:
    cntl = Controller()
    cntl.remote_side = socket.remote_side
    body = msg.body.decode("utf-8", "replace") if msg.body else "{}"
    if msg.is_request and msg.method == "GET" and msg.query:
        body = json.dumps(msg.query)
    # a chunked request is answered chunked: the deterministic echo rule
    # that lets one round trip prove BOTH the parse and emit directions
    # (the parser already rejected any TE other than a lone 'chunked')
    chunked = (msg.headers.get("Transfer-Encoding", "")
               .strip().lower() == "chunked")

    def send(code: int, body_bytes: bytes) -> None:
        socket.write(_render_response(code, body_bytes, "application/json",
                                      chunked=chunked))

    json_rpc_dispatch(server, md, full_name, body, send, start_us, cntl)


# ---- client side ------------------------------------------------------

def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    buf = IOBuf()
    if request is None:
        return buf
    if hasattr(request, "SerializeToString"):
        ok, js = json2pb.pb_to_json(request)
        if not ok:
            raise ValueError(f"cannot jsonify request: {js}")
        buf.append(js)
    elif isinstance(request, (bytes, bytearray, str)):
        buf.append(request)
    else:
        buf.append(json.dumps(request))
    return buf


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    service, _, method = method_full_name.rpartition(".")
    body = payload.to_bytes()
    out = IOBuf()
    host = str(cntl.remote_side) if cntl.remote_side else "localhost"
    out.append(f"POST /{service}/{method} HTTP/1.1\r\n"
               f"Host: {host}\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n"
               f"X-Correlation-Id: {cid}\r\n\r\n".encode())
    out.append(body)
    return out


def process_inline(msg: HttpMessage, socket) -> bool:
    """Runs in the reader, in cut order: a response takes the oldest
    in-flight call's context here, and a request its number in the
    connection's order, never in the concurrent dispatch."""
    if not msg.is_request:
        msg.pipeline_ctx = socket.pop_pipelined_context()
        return False
    if getattr(socket, "_http_order", None) is None:
        socket._http_order = (threading.Lock(), {})
        socket._http_next_in = socket._http_next_out = 0
    msg.seq = socket._http_next_in
    socket._http_next_in += 1
    return False


def process_response(msg: HttpMessage, socket) -> None:
    """HTTP/1.1 single connection answers in order: correlate with the
    context the reader claimed for this response (process_inline)."""
    from ..bthread import id as bthread_id
    ctx = msg.pipeline_ctx
    if ctx is None:
        return
    cid = ctx
    rc, cntl = bthread_id.lock(cid)
    if rc != 0 or cntl is None:
        return
    meta = meta_pb.RpcMeta()
    if msg.status != 200:
        try:
            err = json.loads(msg.body or b"{}")
        except Exception:
            err = {}
        meta.response.error_code = int(err.get("code", errors.EHTTP))
        meta.response.error_text = err.get("error",
                                           f"HTTP {msg.status} {msg.reason}")
        cntl.handle_response(cid, meta, IOBuf())
        return
    if cntl._response_cls is not None:
        ok, resp, err = json2pb.json_to_pb(
            msg.body.decode("utf-8", "replace"), cntl._response_cls)
        if not ok:
            meta.response.error_code = errors.ERESPONSE
            meta.response.error_text = f"bad response JSON: {err}"
            cntl.handle_response(cid, meta, IOBuf())
            return
        cntl.response = resp
    cntl.finish_parsed_response(cid)


PROTOCOL = Protocol(
    name="http",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_inline=process_inline,
    pipelined=True,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("http") is None:
        register_protocol(PROTOCOL)


_register()
