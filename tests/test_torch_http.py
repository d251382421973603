"""HTTP/1.1 on both packages (``brpc_tpu.policy.http`` and
``brpc_tpu_torch.policy.http``): every test of ``tests/test_http.py``
(JSON-RPC over POST and GET, 404 and 400, the builtin pages, /flags set,
tpu_std beside HTTP on one port, the HTTP client and its error mapping,
the chunked parser and emitter) run over each package, then what the port
adds to the reference's tests: the internal port's split, /health at 503
through a drain, restful mappings, the parser's verdicts byte for byte
against the JAX package's, and each package's client against the other's
server over TCP with byte-equal responses.
"""
from __future__ import annotations

import gc
import json
import socket as pysocket
import threading
import time
import types

import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil.iobuf import IOBuf as JBuf
from brpc_tpu.policy import http as jhttp
from brpc_tpu.rpc.protocol import ParseResultType as JPRT
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf
from brpc_tpu_torch.policy import http as thttp
from brpc_tpu_torch.proto.echo_pb2 import (EchoRequest as TReq,
                                           EchoResponse as TResp)
from brpc_tpu_torch.rpc.protocol import ParseResultType as TPRT
from tests.echo_pb2 import EchoRequest as JReq, EchoResponse as JResp

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, http=jhttp, Buf=JBuf,
                            PRT=JPRT, flags=jflags, Req=JReq, Resp=JResp)
PORT = types.SimpleNamespace(name="port", rpc=trpc, http=thttp, Buf=TBuf,
                             PRT=TPRT, flags=tflags, Req=TReq, Resp=TResp)
PKGS = {"jax": JAX, "port": PORT}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(scope="module", autouse=True)
def _drain_sockets():
    """Every connection this module's servers and channels opened is gone
    at its end (the port's socket pool; the JAX package keeps its own)."""
    yield
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and list_sockets():
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()


def _echo_service(pkg, prefix="http:"):
    class EchoService(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            response.message = prefix + request.message
            done()

    return EchoService()


def _server(pkg, **opts):
    o = pkg.rpc.ServerOptions()
    for k, v in opts.items():
        setattr(o, k, v)
    server = pkg.rpc.Server(o)
    server.add_service(_echo_service(pkg))
    assert server.start("127.0.0.1:0") == 0
    return server


def raw_http(port, request: bytes) -> bytes:
    with pysocket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(request)
        data = b""
        s.settimeout(5)
        while b"\r\n\r\n" not in data or not _complete(data):
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        return data


def _complete(data: bytes) -> bool:
    head, _, rest = data.partition(b"\r\n\r\n")
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            return len(rest) >= int(line.split(b":")[1])
    return True


def _chunk(body: bytes, sizes, trailer: bytes = b"") -> bytes:
    out, off = [], 0
    for n in sizes:
        piece = body[off:off + n]
        out.append(b"%x\r\n%s\r\n" % (len(piece), piece))
        off += n
    assert off == len(body)
    out.append(b"0\r\n" + trailer + b"\r\n")
    return b"".join(out)


def _recv_chunked(port, request: bytes) -> bytes:
    with pysocket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(request)
        s.settimeout(5)
        data = b""
        while not data.endswith(b"0\r\n\r\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        return data


# ---- tests/test_http.py::TestHttpServer -----------------------------------

def test_json_rpc_post(pkg):
    server = _server(pkg)
    try:
        body = json.dumps({"message": "hello"}).encode()
        req = (b"POST /EchoService/Echo HTTP/1.1\r\nHost: x\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        resp = raw_http(server.listen_port, req)
        assert resp.startswith(b"HTTP/1.1 200")
        assert json.loads(resp.split(b"\r\n\r\n", 1)[1])["message"] == \
            "http:hello"
    finally:
        server.stop()


def test_get_with_query_params(pkg):
    server = _server(pkg)
    try:
        resp = raw_http(server.listen_port, b"GET /EchoService/Echo?"
                        b"message=qs HTTP/1.1\r\nHost: x\r\n\r\n")
        assert resp.startswith(b"HTTP/1.1 200")
        assert json.loads(resp.split(b"\r\n\r\n", 1)[1])["message"] == \
            "http:qs"
    finally:
        server.stop()


def test_404(pkg):
    server = _server(pkg)
    try:
        resp = raw_http(server.listen_port,
                        b"GET /no/such/thing HTTP/1.1\r\nHost: x\r\n\r\n")
        assert resp.startswith(b"HTTP/1.1 404")
    finally:
        server.stop()


def test_bad_json_is_400(pkg):
    server = _server(pkg)
    try:
        body = b"{not json"
        resp = raw_http(server.listen_port,
                        b"POST /EchoService/Echo HTTP/1.1\r\nHost: x\r\n"
                        b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert resp.startswith(b"HTTP/1.1 400")
    finally:
        server.stop()


@pytest.mark.parametrize("page,needle", [
    ("health", b"OK"),
    ("status", b"EchoService"),
    ("vars", b"rpc_socket_count"),
    ("flags", b"bthread_concurrency"),
    ("connections", b"remote"),
    ("brpc_metrics", b"# TYPE"),
    ("protobufs", b"EchoRequest"),
    ("bthreads", b"workers"),
    ("rpcz", b"spans"),
    ("version", b"brpc_tpu"),
    ("threads", b"--- thread"),
    ("list_services", b"EchoRequest"),
    ("vlog", b"min level"),
    ("dir", b"entries"),
    ("pprof/cmdline", b"python"),
    ("pprof/symbol", b"num_symbols"),
])
def test_builtin_pages(pkg, page, needle):
    server = _server(pkg)
    try:
        resp = raw_http(server.listen_port, b"GET /%s HTTP/1.1\r\nHost: x"
                        b"\r\n\r\n" % page.encode())
        assert resp.startswith(b"HTTP/1.1 200"), resp[:200]
        assert needle in resp
    finally:
        server.stop()


def test_flags_set_via_http(pkg):
    name = f"test_http_reload_{pkg.name}"
    try:
        pkg.flags.define_flag(name, 5, "x", pkg.flags.positive_integer)
    except ValueError:
        pkg.flags.set_flag(name, 5)          # defined by an earlier run
    server = _server(pkg)
    try:
        resp = raw_http(server.listen_port,
                        b"GET /flags?setvalue=%s&to=9 HTTP/1.1\r\nHost: x"
                        b"\r\n\r\n" % name.encode())
        assert b"ok" in resp
        assert pkg.flags.get_flag(name) == 9
    finally:
        server.stop()


def test_protocol_coexists_with_tpu_std(pkg):
    """One port serves tpu_std frames and HTTP text."""
    server = _server(pkg)
    try:
        ch = pkg.rpc.Channel()
        ch.init(f"127.0.0.1:{server.listen_port}")
        cntl = pkg.rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              pkg.Req(message="bin"), pkg.Resp)
        assert not cntl.failed() and resp.message == "http:bin"
        assert b"OK" in raw_http(server.listen_port,
                                 b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
        ch.close()
    finally:
        server.stop()


# ---- tests/test_http.py::TestHttpClient -----------------------------------

def _http_channel(pkg, port, **opts):
    ch = pkg.rpc.Channel()
    ch.init(f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(
        protocol="http", timeout_ms=5000, **opts))
    return ch


def test_channel_with_http_protocol(pkg):
    server = _server(pkg)
    try:
        ch = _http_channel(pkg, server.listen_port)
        cntl = pkg.rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              pkg.Req(message="cli"), pkg.Resp)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "http:cli"
        ch.close()
    finally:
        server.stop()


def test_http_client_error_mapping(pkg):
    server = _server(pkg)
    try:
        ch = _http_channel(pkg, server.listen_port, max_retry=0)
        cntl = pkg.rpc.Controller()
        ch.call_method("NoService.NoMethod", cntl, pkg.Req(message="x"),
                       pkg.Resp)
        assert cntl.failed()
        assert cntl.error_code == pkg.rpc.errors.EHTTP
        ch.close()
    finally:
        server.stop()


# ---- tests/test_http.py::TestChunkedTransferEncoding ----------------------

def test_chunked_request_round_trip_chunked_response(pkg):
    server = _server(pkg)
    try:
        body = json.dumps({"message": "chunky"}).encode()
        framed = _chunk(body, [7, len(body) - 7],
                        trailer=b"X-Trailer: ignored\r\n")
        resp = _recv_chunked(server.listen_port,
                             b"POST /EchoService/Echo HTTP/1.1\r\nHost: t\r\n"
                             b"Content-Type: application/json\r\n"
                             b"Transfer-Encoding: chunked\r\n\r\n" + framed)
        head, _, _rest = resp.partition(b"\r\n\r\n")
        assert b"200" in head.split(b"\r\n")[0]
        assert b"transfer-encoding: chunked" in head.lower()
        assert b"content-length" not in head.lower()
        decoded, consumed = pkg.http._parse_chunked_body(resp, len(head) + 4)
        assert decoded is not None and consumed == len(resp)
        assert json.loads(decoded)["message"] == "http:chunky"
    finally:
        server.stop()


def test_parser_reassembles_split_chunked_delivery(pkg):
    body = b"0123456789abcdef"
    framed = _chunk(body, [4, 12])
    wire = (b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
            + framed)
    for cut in (len(wire) - 1, len(wire) - 8, len(wire) - len(framed)):
        assert pkg.http._parse_http(pkg.Buf(wire[:cut])).type == \
            pkg.PRT.NOT_ENOUGH_DATA
    buf = pkg.Buf(wire)
    pr = pkg.http._parse_http(buf)
    assert pr.type == pkg.PRT.OK
    assert pr.message.body == body
    assert len(buf) == 0


def test_chunked_response_parsed_by_client_parser(pkg):
    payload = json.dumps({"message": "streamed"}).encode()
    wire = (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
            + _chunk(payload, [3, len(payload) - 3]))
    pr = pkg.http._parse_http(pkg.Buf(wire))
    assert pr.type == pkg.PRT.OK
    assert not pr.message.is_request
    assert json.loads(pr.message.body)["message"] == "streamed"


def test_malformed_chunk_size_is_a_parse_error(pkg):
    for bad in (b"zz", b"-2", b"+5", b"0x10", b"1_0", b""):
        wire = (b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
                + bad + b"\r\nbody\r\n0\r\n\r\n")
        assert pkg.http._parse_http(pkg.Buf(wire)).type == \
            pkg.PRT.ERROR, bad


def test_transfer_encoding_must_be_a_lone_chunked_token(pkg):
    body = _chunk(b"hello", [5])
    for te in (b"gzip, chunked", b"xchunked", b"chunked, gzip",
               b"chunkedx"):
        wire = (b"POST /x HTTP/1.1\r\nTransfer-Encoding: " + te
                + b"\r\n\r\n" + body)
        assert pkg.http._parse_http(pkg.Buf(wire)).type == \
            pkg.PRT.ERROR, te
    wire = (b"POST /x HTTP/1.1\r\nTransfer-Encoding:  Chunked \r\n\r\n"
            + body)
    pr = pkg.http._parse_http(pkg.Buf(wire))
    assert pr.type == pkg.PRT.OK and pr.message.body == b"hello"


def test_chunk_extension_is_ignored(pkg):
    wire = (b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
            b"5;ext=1\r\nhello\r\n0\r\n\r\n")
    pr = pkg.http._parse_http(pkg.Buf(wire))
    assert pr.type == pkg.PRT.OK
    assert pr.message.body == b"hello"


# ---- what the port adds ----------------------------------------------------

_PARSER_CASES = [
    b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /A/B?x=1&y=two HTTP/1.1\r\nContent-Length: 3\r\n\r\nabc",
    b"POST /A/B HTTP/1.1\r\nContent-Length: 9\r\n\r\nabc",
    b"HTTP/1.1 404 Not Found\r\nContent-Length: 2\r\n\r\n{}",
    b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n3\r\nabc\r\n0\r\n\r\n",
    b"PUT /x HTTP/1.1\r\nTransfer-Encoding: gzip\r\n\r\n",
    b"TRPC\x00\x00\x00\x10",
    b"GE",
    b"DELETE /k HTTP/1.1\r\n\r\nGET /next HTTP/1.1\r\n\r\n",
]


@pytest.mark.parametrize("case", range(len(_PARSER_CASES)))
def test_parser_verdicts_equal_the_jax_package(case):
    """The same bytes get the same verdict, message and leftover from both
    parsers."""
    wire = _PARSER_CASES[case]

    def run(p):
        buf = p.Buf(wire)
        pr = p.http._parse_http(buf)
        m = pr.message
        return (pr.type.name, len(buf), None if m is None else (
            m.is_request, m.method, m.path, sorted(m.query.items()),
            m.status, m.reason, sorted(m.headers.items()), m.body))

    assert run(PORT) == run(JAX)


def test_response_bytes_equal_the_jax_package():
    """The emitter writes the JAX package's bytes, chunked or not."""
    for status in (200, 403, 404, 503):
        for chunked in (False, True):
            args = (status, b'{"a": 1}', "application/json", None, chunked)
            assert thttp._render_response(*args).to_bytes() == \
                jhttp._render_response(*args).to_bytes()


def test_internal_port_serves_pages_only_there(pkg):
    """With ``internal_port`` set the pages leave the public port (403)
    and the internal port serves nothing else (403 for a method)."""
    server = _server(pkg, internal_port=0)
    try:
        public, internal = server.listen_port, server.internal_port
        assert internal > 0 and internal != public
        for page in (b"health", b"vars", b"status"):
            req = b"GET /%s HTTP/1.1\r\nHost: x\r\n\r\n" % page
            assert raw_http(internal, req).startswith(b"HTTP/1.1 200")
            assert raw_http(public, req).startswith(b"HTTP/1.1 403")
        body = b'{"message": "m"}'
        req = (b"POST /EchoService/Echo HTTP/1.1\r\nContent-Length: %d"
               b"\r\n\r\n%s" % (len(body), body))
        assert raw_http(public, req).startswith(b"HTTP/1.1 200")
        assert raw_http(internal, req).startswith(b"HTTP/1.1 403")
    finally:
        server.stop()


def test_health_is_503_while_draining():
    """The port's server in its lame-duck window answers /health 503, and
    a JSON call 503 with the retryable ELOGOFF code, on a connection
    opened before the drain and on one opened during it (the listener
    stays open through the window)."""
    gate = threading.Event()

    class Slow(trpc.Service):
        @trpc.method(TReq, TResp)
        def Wait(self, cntl, request, response, done):
            gate.wait(10)
            done()

    slow = trpc.Server()
    slow.add_service(Slow())
    assert slow.start("127.0.0.1:0") == 0
    port = slow.listen_port
    get_health = b"GET /health HTTP/1.1\r\n\r\n"
    try:
        ch = trpc.Channel()
        ch.init(f"127.0.0.1:{port}", options=trpc.ChannelOptions(
            timeout_ms=10000, max_retry=0))
        held = trpc.Controller()
        ch.call_method("Slow.Wait", held, TReq(message="w"), TResp,
                       done=lambda c: None)
        deadline = time.monotonic() + 5
        while slow.inflight_requests() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        early = pysocket.create_connection(("127.0.0.1", port), timeout=5)
        early.sendall(get_health)
        assert early.recv(65536).startswith(b"HTTP/1.1 200")
        stopper = threading.Thread(target=slow.stop, args=(5.0,))
        stopper.start()
        deadline = time.monotonic() + 5
        while not slow.is_draining() and time.monotonic() < deadline:
            time.sleep(0.005)
        early.sendall(get_health)
        assert early.recv(65536).startswith(b"HTTP/1.1 503")
        early.close()
        assert raw_http(port, get_health).startswith(b"HTTP/1.1 503")
        body = b'{"message": "x"}'
        resp = raw_http(port, b"POST /Slow/Wait HTTP/1.1\r\nContent-Length:"
                        b" %d\r\n\r\n%s" % (len(body), body))
        assert resp.startswith(b"HTTP/1.1 503")
        assert json.loads(resp.split(b"\r\n\r\n", 1)[1])["code"] == \
            trpc.errors.ELOGOFF
        gate.set()
        stopper.join(10)
        ch.close()
    finally:
        gate.set()
        slow.stop()


def test_restful_mapping(pkg):
    server = _server(pkg, restful_mappings={"/v1/echo": "EchoService.Echo"})
    try:
        body = b'{"message": "rest"}'
        resp = raw_http(server.listen_port,
                        b"POST /v1/echo HTTP/1.1\r\nContent-Length: %d\r\n"
                        b"\r\n%s" % (len(body), body))
        assert resp.startswith(b"HTTP/1.1 200")
        assert json.loads(resp.split(b"\r\n\r\n", 1)[1])["message"] == \
            "http:rest"
    finally:
        server.stop()


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_cross_package_http(client, server):
    """Each package's HTTP client against the other's server over TCP:
    the answers equal those of the server's own package's client, and the
    raw responses are byte-equal across the two servers."""
    c, s = PKGS[client], PKGS[server]
    srv = _server(s)
    twin = _server(c)
    try:
        ch = _http_channel(c, srv.listen_port)
        for i in range(20):
            cntl = c.rpc.Controller()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  c.Req(message=f"m{i}"), c.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == f"http:m{i}"
        cntl = c.rpc.Controller()
        ch.call_method("No.Such", cntl, c.Req(message="x"), c.Resp)
        assert cntl.failed() and cntl.error_code == c.rpc.errors.EHTTP
        ch.close()
        body = b'{"message": "same"}'
        req = (b"POST /EchoService/Echo HTTP/1.1\r\nContent-Length: %d"
               b"\r\n\r\n%s" % (len(body), body))
        assert raw_http(srv.listen_port, req) == \
            raw_http(twin.listen_port, req)
    finally:
        srv.stop()
        twin.stop()


def test_pipelined_responses_keep_their_calls():
    """Many concurrent calls share one HTTP/1.1 connection to the port's
    server: it answers in request order whichever handler finishes first,
    and each answer reaches the call that sent its request.  (The JAX
    package's server answers in completion order, so its concurrent calls
    on one connection can swap answers.)"""
    pkg = PORT

    class Jitter(trpc.Service):
        SERVICE_NAME = "EchoService"

        @trpc.method(TReq, TResp)
        def Echo(self, cntl, request, response, done):
            time.sleep(sum(request.message.encode()) % 5 / 1000.0)
            response.message = "http:" + request.message
            done()

    server = trpc.Server()
    server.add_service(Jitter())
    assert server.start("127.0.0.1:0") == 0
    errs = []
    try:
        ch = _http_channel(pkg, server.listen_port)

        def worker(w):
            for i in range(10):
                cntl = pkg.rpc.Controller()
                msg = f"w{w}:{i}"
                resp = ch.call_method("EchoService.Echo", cntl,
                                      pkg.Req(message=msg), pkg.Resp)
                if cntl.failed() or resp.message != "http:" + msg:
                    errs.append((msg, cntl.error_text,
                                 resp and resp.message))

        ts = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs[:3]
        ch.close()
    finally:
        server.stop()
