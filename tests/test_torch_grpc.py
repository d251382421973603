"""HTTP/2 + gRPC on both packages (``brpc_tpu.policy.{grpc,hpack}`` and
``brpc_tpu_torch.policy.{grpc,hpack}``): every test of
``tests/test_grpc.py`` (HPACK and framing goldens, unary calls over mem://
and TCP, status mapping, ``grpc-timeout``, max_concurrency, flow control
with parking and the SETTINGS retro-adjust, CONTINUATION, padding and
priority, the REST half of h2 with its authenticator, RST_STREAM and
GOAWAY, the authorization header, the pack golden, RFC 7541 Appendix C)
run over each package; the ``h2_curl_*`` transcripts of
``tests/test_foreign_interop.py`` decoded by both; then what the port
adds: the transcript replayed into the port's server, the frames each
package writes compared byte for byte, each package's client against the
other's server over TCP, the GOAWAY of a stop with calls in flight, the
server-side deadline, compression and the HMAC authenticator.
"""
from __future__ import annotations

import gc
import json
import os
import struct
import threading
import time
import types

import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.bthread import id as jid
from brpc_tpu.butil.iobuf import IOBuf as JBuf
from brpc_tpu.policy import grpc as jg2
from brpc_tpu.policy import hpack as jhpack
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.bthread import scheduler as tsched
from brpc_tpu_torch.bthread import id as tid
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf
from brpc_tpu_torch.policy import auth as tauth
from brpc_tpu_torch.policy import grpc as tg2
from brpc_tpu_torch.policy import hpack as thpack
from brpc_tpu_torch.proto.echo_pb2 import (EchoRequest as TReq,
                                           EchoResponse as TResp)
from brpc_tpu_torch.rpc import compress as tcompress
from tests.echo_pb2 import EchoRequest as JReq, EchoResponse as JResp

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")

JAX = types.SimpleNamespace(
    name="jax", rpc=jrpc, g2=jg2, hpack=jhpack, Buf=JBuf, errors=jrpc.errors,
    Req=JReq, Resp=JResp, create_id=lambda cb: jid.create(None, cb),
    id=jid)
PORT = types.SimpleNamespace(
    name="port", rpc=trpc, g2=tg2, hpack=thpack, Buf=TBuf,
    errors=trpc.errors, Req=TReq, Resp=TResp,
    create_id=lambda cb: tid.create_ranged(None, cb, 1), id=tid)
PKGS = {"jax": JAX, "port": PORT}
_seq = [7000]


def unique(p):
    _seq[0] += 1
    return f"{p}-{_seq[0]}"


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(scope="module", autouse=True)
def _drain_sockets():
    """The port's connections this module opened are gone at its end."""
    yield
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and list_sockets():
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()


def _echo_service(pkg):
    class GrpcEchoService(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            response.message = "grpc:" + request.message
            done()

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Fail(self, cntl, request, response, done):
            cntl.set_failed(pkg.errors.EINTERNAL, "grpc boom")
            done()

    return GrpcEchoService()


class _Started:
    """A server and a grpc channel to it; closed on exit."""

    def __init__(self, pkg, transport="mem", service=None, sopts=None,
                 **chopts):
        self.server = pkg.rpc.Server(sopts)
        self.server.add_service(service or _echo_service(pkg))
        if transport == "mem":
            name = unique("grpc")
            assert self.server.start(f"mem://{name}") == 0
            self.target = f"mem://{name}"
        else:
            assert self.server.start("127.0.0.1:0") == 0
            self.target = f"127.0.0.1:{self.server.listen_port}"
        self.channels = []
        self.ch = self.channel(pkg, **chopts)

    def channel(self, pkg, **opts):
        ch = pkg.rpc.Channel()
        opts.setdefault("timeout_ms", 5000)
        ch.init(self.target, options=pkg.rpc.ChannelOptions(
            protocol="grpc", **opts))
        self.channels.append(ch)
        return ch

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for ch in self.channels:
            ch.close()
        self.server.stop()


def _echo(pkg, ch, msg, cntl=None):
    cntl = cntl or pkg.rpc.Controller()
    resp = ch.call_method("EchoService.Echo", cntl, pkg.Req(message=msg),
                          pkg.Resp)
    return cntl, resp


# ---- TestHpack ---------------------------------------------------------

def test_static_indexed_roundtrip(pkg):
    enc, dec = pkg.hpack.Encoder(), pkg.hpack.Decoder()
    headers = [(b":method", b"POST"), (b":scheme", b"http"),
               (b":status", b"200")]
    assert dec.decode(enc.encode(headers)) == headers


def test_literal_roundtrip(pkg):
    enc, dec = pkg.hpack.Encoder(), pkg.hpack.Decoder()
    headers = [(b":path", b"/Echo/Do"), (b"grpc-status", b"0"),
               (b"x-custom", b"v" * 300)]
    assert dec.decode(enc.encode(headers)) == headers


def test_dynamic_table_incremental(pkg):
    dec = pkg.hpack.Decoder()
    name, value = b"x-session", b"abc"
    block = (bytes([0x40]) + bytes([len(name)]) + name
             + bytes([len(value)]) + value)
    assert dec.decode(block) == [(name, value)]
    assert dec.decode(bytes([0x80 | 62])) == [(name, value)]


def test_huffman_decode(pkg):
    data = bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff")
    assert pkg.hpack.huffman_decode(data) == b"www.example.com"


def test_integer_coding(pkg):
    assert pkg.hpack._encode_int(10, 5, 0) == bytes([10])
    raw = pkg.hpack._encode_int(1337, 5, 0)
    v, pos = pkg.hpack._decode_int(raw, 0, 5)
    assert v == 1337 and pos == len(raw)


# ---- TestFrames ---------------------------------------------------------

def test_frame_header(pkg):
    g2 = pkg.g2
    f = g2.frame(g2.FRAME_DATA, g2.FLAG_END_STREAM, 5, b"hello")
    assert len(f) == 9 + 5
    assert int.from_bytes(f[:3], "big") == 5
    assert f[3] == g2.FRAME_DATA
    assert f[4] == g2.FLAG_END_STREAM
    assert int.from_bytes(f[5:9], "big") == 5


def test_grpc_message_framing(pkg):
    g2 = pkg.g2
    m = g2.grpc_message(b"PAYLOAD")
    assert m[0] == 0
    assert struct.unpack(">I", m[1:5])[0] == 7
    assert g2.split_grpc_messages(m + g2.grpc_message(b"x")) == \
        [b"PAYLOAD", b"x"]


# ---- TestGrpcEndToEnd ----------------------------------------------------

def test_unary_call_mem(pkg):
    with _Started(pkg, "mem") as s:
        cntl, resp = _echo(pkg, s.ch, "hi")
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "grpc:hi"


def test_unary_call_tcp(pkg):
    with _Started(pkg, "tcp") as s:
        cntl, resp = _echo(pkg, s.ch, "tcp")
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "grpc:tcp"


def test_multiple_calls_one_connection(pkg):
    with _Started(pkg, "mem") as s:
        for i in range(10):
            cntl, resp = _echo(pkg, s.ch, f"n{i}")
            assert not cntl.failed(), cntl.error_text
            assert resp.message == f"grpc:n{i}"


def test_server_error_maps_to_grpc_status(pkg):
    with _Started(pkg, "mem") as s:
        cntl = pkg.rpc.Controller()
        s.ch.call_method("EchoService.Fail", cntl, pkg.Req(message="x"),
                         pkg.Resp)
        assert cntl.failed()
        assert "grpc boom" in cntl.error_text


def test_unknown_method_is_unimplemented(pkg):
    with _Started(pkg, "mem") as s:
        cntl = pkg.rpc.Controller()
        s.ch.call_method("EchoService.Nope", cntl, pkg.Req(message="x"),
                         pkg.Resp)
        assert cntl.failed()
        assert cntl.error_code == pkg.errors.ENOMETHOD


def test_grpc_timeout_header_propagates_deadline(pkg):
    seen = {}

    class DeadlineProbe(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            seen["deadline"] = cntl.method_deadline
            seen["now"] = time.monotonic()
            response.message = "ok"
            done()

    with _Started(pkg, "mem", service=DeadlineProbe(),
                  timeout_ms=2345) as s:
        cntl, resp = _echo(pkg, s.ch, "x")
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "ok"
        assert seen["deadline"] is not None
        left = seen["deadline"] - seen["now"]
        assert 0 < left <= 2.345 + 0.05, left


def test_grpc_server_enforces_max_concurrency(pkg):
    gate = threading.Event()
    entered = threading.Event()

    class Slow(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            entered.set()
            gate.wait(10)
            response.message = "done"
            done()

    opts = pkg.rpc.ServerOptions()
    opts.max_concurrency = 1
    try:
        with _Started(pkg, "mem", service=Slow(), sopts=opts,
                      timeout_ms=15000) as s:
            first = {}

            def occupy():
                c, r = _echo(pkg, s.ch, "a")
                first["failed"] = c.failed()
                first["resp"] = r

            t = threading.Thread(target=occupy)
            t.start()
            assert entered.wait(10)
            cntl, _ = _echo(pkg, s.ch, "b")
            assert cntl.failed()
            assert cntl.error_code == pkg.errors.ELIMIT
            gate.set()
            t.join(10)
            assert first["failed"] is False
            assert first["resp"].message == "done"
    finally:
        gate.set()


def test_grpc_timeout_unit_parsing(pkg):
    p = pkg.g2.parse_grpc_timeout_ms
    assert p(b"100m") == 100
    assert p(b"2S") == 2000
    assert p(b"1M") == 60000
    assert p(b"500u") == 1
    assert p(b"") is None
    assert p(b"abcm") is None
    assert p(b"100x") is None


def test_status_codes_map_both_directions(pkg):
    class Limited(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            cntl.set_failed(pkg.errors.ELIMIT, "too busy")
            done()

    with _Started(pkg, "mem", service=Limited()) as s:
        cntl, _ = _echo(pkg, s.ch, "x")
        assert cntl.failed()
        assert cntl.error_code == pkg.errors.ELIMIT
        assert "too busy" in cntl.error_text


def test_large_message_crosses_flow_control_window(pkg):
    with _Started(pkg, "mem") as s:
        big = "x" * 300_000
        cntl = pkg.rpc.Controller()
        cntl.timeout_ms = 30000
        cntl, resp = _echo(pkg, s.ch, big, cntl)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "grpc:" + big


def test_multiplexed_concurrent_calls(pkg):
    errs = []
    with _Started(pkg, "mem") as s:
        def worker(wid):
            try:
                for i in range(8):
                    msg = f"w{wid}:{i}:" + "y" * (wid * 997)
                    cntl, resp = _echo(pkg, s.ch, msg)
                    assert not cntl.failed(), cntl.error_text
                    assert resp.message == "grpc:" + msg
            except Exception as e:   # collected for the assertion below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs, errs


# ---- the frame layer ----------------------------------------------------

class _FakeH2Socket:
    """Capture-only socket for frame-layer unit tests (mimics the real
    Socket's failure-hook contract)."""

    def __init__(self):
        self.sent = bytearray()
        self.remote_side = "fake"
        self.on_failed_callbacks = []
        self.failed_with = None
        self.logoff = False

    def write(self, buf, **kw):
        self.sent.extend(buf.to_bytes())
        return 0

    def set_failed(self, code, text=""):
        if self.failed_with is not None:
            return False
        self.failed_with = (code, text)
        for cb in list(self.on_failed_callbacks):
            cb(self)
        return True

    def drain_frames(self):
        out = []
        data = bytes(self.sent)
        pos = 0
        while pos + 9 <= len(data):
            length = int.from_bytes(data[pos:pos + 3], "big")
            out.append((data[pos + 3], data[pos + 4],
                        int.from_bytes(data[pos + 5:pos + 9], "big"),
                        data[pos + 9:pos + 9 + length]))
            pos += 9 + length
        self.sent.clear()
        return out


def _client_conn(pkg):
    sock = _FakeH2Socket()
    conn = pkg.g2._H2Conn(is_server=False)
    sock._h2_conn = conn
    return pkg.g2, sock, conn


def test_data_parks_beyond_window_and_drains_on_update(pkg):
    g, sock, conn = _client_conn(pkg)
    out = pkg.Buf()
    with conn.lock:
        g._send_data(conn, out, 1, b"z" * 100_000, end_stream=True)
    sock.write(out)
    frames = sock.drain_frames()
    assert sum(len(p) for _t, _f, _s, p in frames) == 65535
    assert all(len(p) <= g.DEFAULT_MAX_FRAME for _t, _f, _s, p in frames)
    assert not any(f & g.FLAG_END_STREAM for _t, f, _s, p in frames)
    assert conn.send_window == 0
    assert 1 in conn.pending
    g._on_window_update(conn, sock, 0, 100_000)
    g._on_window_update(conn, sock, 1, 100_000)
    frames = sock.drain_frames()
    assert sum(len(p) for _t, _f, _s, p in frames) == 100_000 - 65535
    assert frames[-1][1] & g.FLAG_END_STREAM
    assert not conn.pending


def test_settings_initial_window_retro_adjusts(pkg):
    g, sock, conn = _client_conn(pkg)
    out = pkg.Buf()
    with conn.lock:
        g._send_data(conn, out, 1, b"a" * 65535, end_stream=False)
    assert conn.stream_send[1] == 0
    g._apply_settings(conn, sock, struct.pack(
        ">HI", g.SETTINGS_INITIAL_WINDOW_SIZE, 66535))
    assert conn.stream_send[1] == 1000
    assert conn.max_frame_size == g.DEFAULT_MAX_FRAME
    g._apply_settings(conn, sock, struct.pack(
        ">HI", g.SETTINGS_MAX_FRAME_SIZE, 32768))
    assert conn.max_frame_size == 32768


def test_window_update_before_first_data_keeps_credit(pkg):
    g = pkg.g2
    for known_via in ("streams", "serving"):
        sock = _FakeH2Socket()
        conn = g._H2Conn(is_server=True)
        sock._h2_conn = conn
        if known_via == "streams":
            conn.streams[1] = g._H2Stream(1)
        else:
            conn.serving.add(1)
        g._on_window_update(conn, sock, 1, 10_000)
        assert 1 not in conn.stream_send
        conn.send_window = 1 << 20
        out = pkg.Buf()
        payload = b"y" * (g.DEFAULT_WINDOW + 10_000)
        with conn.lock:
            g._send_data(conn, out, 1, payload, end_stream=True)
        sock.write(out)
        frames = sock.drain_frames()
        assert sum(len(p) for _t, _f, _s, p in frames) == len(payload)
        assert frames[-1][1] & g.FLAG_END_STREAM
        assert 1 not in conn.pending
        assert not conn.stream_send and not conn.early_credit \
            and not conn.serving
    g._on_window_update(conn, sock, 99, 5_000)
    assert 99 not in conn.stream_send and 99 not in conn.early_credit


def test_client_conn_does_not_leak_per_call_state(pkg):
    g, sock, conn = _client_conn(pkg)
    for call in range(5):
        sid = 1 + 2 * call
        conn.cid_by_stream[sid] = 100 + sid
        out = pkg.Buf()
        with conn.lock:
            g._send_data(conn, out, sid, b"req", end_stream=True)
        g._on_window_update(conn, sock, sid, 3)
        conn.streams[sid] = g._H2Stream(sid)
        g._handle_frame(conn, sock, g.FRAME_DATA, g.FLAG_END_STREAM, sid,
                        b"", [])
        conn.cid_by_stream.pop(sid, None)
    assert conn.stream_send == {}
    assert conn.early_credit == {}
    assert conn.streams == {} and conn.serving == set()


def _server_conn(pkg):
    sock = _FakeH2Socket()
    conn = pkg.g2._H2Conn(is_server=True)
    sock._h2_conn = conn
    return sock, conn


def test_padded_frame_validation(pkg):
    g = pkg.g2
    for payload in (b"", bytes([5]) + b"abc"):
        sock, conn = _server_conn(pkg)
        g._handle_frame(conn, sock, g.FRAME_DATA, g.FLAG_PADDED, 1, payload,
                        [])
        assert sock.failed_with is not None
        sock2, conn2 = _server_conn(pkg)
        g._handle_frame(conn2, sock2, g.FRAME_HEADERS,
                        g.FLAG_PADDED | g.FLAG_END_HEADERS, 1, payload, [])
        assert sock2.failed_with is not None
    sock, conn = _server_conn(pkg)
    g._handle_frame(conn, sock, g.FRAME_DATA, g.FLAG_PADDED, 1,
                    bytes([3]) + b"\0\0\0", [])
    assert sock.failed_with is None
    assert bytes(conn.streams[1].data) == b""
    good = bytes([2]) + b"\x00\x00\x00\x00\x10" + b"\0\0"
    bad = bytes([3]) + b"\x00\x00\x00\x00\x10" + b"\0\0"
    for payload, ok in ((good, True), (bad, False)):
        sock, conn = _server_conn(pkg)
        g._handle_frame(conn, sock, g.FRAME_HEADERS,
                        g.FLAG_PADDED | g.FLAG_PRIORITY | g.FLAG_END_HEADERS,
                        1, payload, [])
        assert (sock.failed_with is None) == ok, (payload, ok)


def test_trailers_never_jump_parked_data(pkg):
    g, sock, conn = _client_conn(pkg)
    conn.settings_sent = True
    g._send_grpc_response(sock, 1, b"q" * 100_000, 0, "")
    frames = sock.drain_frames()
    assert frames[0][0] == g.FRAME_HEADERS
    assert frames[-1][0] == g.FRAME_DATA
    g._on_window_update(conn, sock, 0, 1 << 20)
    g._on_window_update(conn, sock, 1, 1 << 20)
    frames = sock.drain_frames()
    assert frames[-1][0] == g.FRAME_HEADERS
    assert frames[-1][1] & g.FLAG_END_STREAM


# ---- TestH2Continuation ----------------------------------------------------

def test_header_block_split_mid_string_reassembles(pkg):
    g = pkg.g2
    block = pkg.hpack.Encoder(index=False).encode(
        [(b":path", b"/Svc/Method"), (b"x-long", b"v" * 100)])
    sock, conn = _server_conn(pkg)
    completed = []
    cut = len(block) // 2
    g._handle_frame(conn, sock, g.FRAME_HEADERS, 0, 1, block[:cut],
                    completed)
    assert conn.streams[1].headers == []
    g._handle_frame(conn, sock, g.FRAME_CONTINUATION, g.FLAG_END_HEADERS, 1,
                    block[cut:], completed)
    st = conn.streams[1]
    assert (b":path", b"/Svc/Method") in st.headers
    assert (b"x-long", b"v" * 100) in st.headers


def test_outgoing_giant_header_block_splits(pkg):
    g = pkg.g2
    conn = g._H2Conn(is_server=False)
    out = pkg.Buf()
    block = b"h" * (g.DEFAULT_MAX_FRAME * 2 + 100)
    with conn.lock:
        g._append_header_block(conn, out, 1, block, end_stream=False)
    sock = _FakeH2Socket()
    sock.write(out)
    frames = sock.drain_frames()
    assert [f[0] for f in frames] == [g.FRAME_HEADERS, g.FRAME_CONTINUATION,
                                      g.FRAME_CONTINUATION]
    assert not frames[0][1] & g.FLAG_END_HEADERS
    assert not frames[1][1] & g.FLAG_END_HEADERS
    assert frames[2][1] & g.FLAG_END_HEADERS
    assert b"".join(f[3] for f in frames) == block


def test_padded_and_priority_flags_stripped(pkg):
    g = pkg.g2
    block = pkg.hpack.Encoder(index=False).encode([(b":path", b"/x")])
    sock, conn = _server_conn(pkg)
    payload = bytes([3]) + b"\x00\x00\x00\x00\x10" + block + b"\0\0\0"
    g._handle_frame(conn, sock, g.FRAME_HEADERS,
                    g.FLAG_END_HEADERS | g.FLAG_PADDED | g.FLAG_PRIORITY, 1,
                    payload, [])
    assert conn.streams[1].headers == [(b":path", b"/x")]


# ---- TestH2Rest ---------------------------------------------------------------

def _rest_roundtrip(pkg, path, body, content_type=b"application/json",
                    server=None, extra_headers=()):
    g = pkg.g2
    if server is None:
        server = pkg.rpc.Server()
        server.add_service(_echo_service(pkg))
    sock = _FakeH2Socket()
    arg = types.SimpleNamespace(server=server)
    block = pkg.hpack.Encoder(index=False).encode(
        [(b":method", b"POST"), (b":path", path.encode()),
         (b":scheme", b"http"), (b"content-type", content_type),
         *extra_headers])
    wire = (g.PREFACE + g.frame(g.FRAME_SETTINGS, 0, 0, b"")
            + g.frame(g.FRAME_HEADERS, g.FLAG_END_HEADERS, 1, block)
            + g.frame(g.FRAME_DATA, g.FLAG_END_STREAM, 1, body))
    result = g.parse(pkg.Buf(wire), sock, False, arg)
    sock.sent.clear()
    g.process_request(result.message, sock, server)
    frames = sock.drain_frames()
    dec = pkg.hpack.Decoder()
    headers, data = [], bytearray()
    for ftype, _flags, _sid, payload in frames:
        if ftype == g.FRAME_HEADERS:
            headers.extend(dec.decode(payload))
        elif ftype == g.FRAME_DATA:
            data.extend(payload)
    return dict(headers), bytes(data), frames


def test_json_request_gets_http_response(pkg):
    g = pkg.g2
    headers, data, frames = _rest_roundtrip(pkg, "/EchoService/Echo",
                                            b'{"message":"rest"}')
    assert headers[b":status"] == b"200"
    assert headers[b"content-type"] == b"application/json"
    assert json.loads(data)["message"] == "grpc:rest"
    assert frames[-1][0] == g.FRAME_DATA
    assert frames[-1][1] & g.FLAG_END_STREAM
    assert sum(1 for f in frames if f[0] == g.FRAME_HEADERS) == 1


def test_unknown_path_is_404(pkg):
    headers, _data, _ = _rest_roundtrip(pkg, "/No/Such", b"{}")
    assert headers[b":status"] == b"404"


def test_rest_bad_json_is_400(pkg):
    headers, _data, _ = _rest_roundtrip(pkg, "/EchoService/Echo",
                                        b"not-json{")
    assert headers[b":status"] == b"400"


def test_rest_cannot_bypass_authenticator(pkg):
    class Auth:
        def verify(self, token, socket):
            return token == "Bearer ok"

    sopts = pkg.rpc.ServerOptions()
    sopts.auth = Auth()
    server = pkg.rpc.Server(sopts)
    server.add_service(_echo_service(pkg))
    headers, _, _ = _rest_roundtrip(pkg, "/EchoService/Echo",
                                    b'{"message":"x"}', server=server)
    assert headers[b":status"] == b"401"
    headers, _data, _ = _rest_roundtrip(
        pkg, "/EchoService/Echo", b'{"message":"x"}', server=server,
        extra_headers=[(b"authorization", b"Bearer ok")])
    assert headers[b":status"] == b"200"


def test_rest_counts_against_server_concurrency(pkg):
    sopts = pkg.rpc.ServerOptions()
    sopts.max_concurrency = 1
    server = pkg.rpc.Server(sopts)
    server.add_service(_echo_service(pkg))
    assert server.on_request_in()
    headers, _, _ = _rest_roundtrip(pkg, "/EchoService/Echo",
                                    b'{"message":"x"}', server=server)
    assert headers[b":status"] == b"503"
    server.on_request_out()
    headers, _, _ = _rest_roundtrip(pkg, "/EchoService/Echo",
                                    b'{"message":"x"}', server=server)
    assert headers[b":status"] == b"200"
    assert server._server_concurrency == 0


# ---- TestH2StreamFailure ----------------------------------------------------

def _client_conn_with_call(pkg):
    g = pkg.g2
    sock = _FakeH2Socket()
    conn = g._conn(sock, is_server=False)       # registers the failure hook
    results = {}

    def on_error(_data, cid, code):
        results["code"] = code
        pkg.id.unlock_and_destroy(cid)

    conn.cid_by_stream[1] = pkg.create_id(on_error)
    return g, sock, conn, results


def test_rst_stream_fails_the_call(pkg):
    g, sock, conn, results = _client_conn_with_call(pkg)
    g._handle_frame(conn, sock, g.FRAME_RST_STREAM, 0, 1,
                    (8).to_bytes(4, "big"), [])
    assert results.get("code") == pkg.errors.ECANCELED
    assert 1 not in conn.cid_by_stream


def test_refused_stream_is_retryable(pkg):
    g, sock, conn, results = _client_conn_with_call(pkg)
    g._handle_frame(conn, sock, g.FRAME_RST_STREAM, 0, 1,
                    (7).to_bytes(4, "big"), [])
    assert results.get("code") == pkg.errors.EAGAIN
    assert pkg.rpc.Controller._retryable(results["code"])


def test_goaway_refuses_unprocessed_streams_retryably(pkg):
    g, sock, conn, results = _client_conn_with_call(pkg)
    conn.pending[1] = [[b"parked", True]]
    g._handle_frame(conn, sock, g.FRAME_GOAWAY, 0, 0,
                    (0).to_bytes(4, "big") + b"\x00" * 4, [])
    assert results.get("code") == pkg.errors.EAGAIN
    assert pkg.rpc.Controller._retryable(results["code"])
    assert 1 not in conn.pending
    assert not conn.cid_by_stream
    assert sock.logoff
    assert sock.failed_with is not None
    assert "drained" in sock.failed_with[1]


def test_goaway_honors_last_stream_id(pkg):
    g = pkg.g2
    sock = _FakeH2Socket()
    conn = g._conn(sock, is_server=False)
    results = {}

    def on_error(sid):
        def cb(_data, cid, code):
            results[sid] = code
            pkg.id.unlock_and_destroy(cid)
        return cb

    conn.cid_by_stream[1] = pkg.create_id(on_error(1))
    conn.cid_by_stream[3] = pkg.create_id(on_error(3))
    g._handle_frame(conn, sock, g.FRAME_GOAWAY, 0, 0,
                    (1).to_bytes(4, "big") + b"\x00" * 4, [])
    assert results == {3: pkg.errors.EAGAIN}
    assert 1 in conn.cid_by_stream
    assert sock.logoff and sock.failed_with is None
    cntl = types.SimpleNamespace(_pack_socket=sock)
    with pytest.raises(ConnectionError):
        g.pack_request(pkg.Buf(), 7, cntl, "Svc.Method")
    conn.streams[1] = g._H2Stream(1)
    g._handle_frame(conn, sock, g.FRAME_DATA, g.FLAG_END_STREAM, 1, b"", [])
    with conn.lock:
        conn.cid_by_stream.pop(1, None)
    g._close_if_drained(conn, sock)
    assert sock.failed_with is not None
    assert "drained" in sock.failed_with[1]


def test_any_socket_death_fails_outstanding_calls(pkg):
    _g, sock, _conn, results = _client_conn_with_call(pkg)
    sock.set_failed(pkg.errors.EFAILEDSOCKET, "connection reset by peer")
    assert results.get("code") == pkg.errors.EFAILEDSOCKET


def test_server_stop_sends_goaway(pkg):
    g = pkg.g2
    sock, conn = _server_conn(pkg)
    conn.last_processed_sid = 5
    g.send_goaway(sock)
    frames = sock.drain_frames()
    assert frames[0][0] == g.FRAME_GOAWAY
    last_sid, err = struct.unpack(">II", frames[0][3])
    assert last_sid == 5 and err == 0


def test_goaway_is_idempotent(pkg):
    g, sock, conn, results = _client_conn_with_call(pkg)
    g._handle_frame(conn, sock, g.FRAME_GOAWAY, 0, 0,
                    (0).to_bytes(4, "big") + b"\x00" * 4, [])
    assert results.get("code") == pkg.errors.EAGAIN
    results.clear()
    g._handle_frame(conn, sock, g.FRAME_GOAWAY, 0, 0,
                    (0).to_bytes(4, "big") + b"\x00" * 4, [])
    assert "code" not in results


# ---- TestGrpcAuth ---------------------------------------------------------

def test_authorization_header_round_trip(pkg):
    class TokenAuth:
        def generate_credential(self, cntl):
            return "Bearer sesame"

        def verify(self, token, socket):
            return token == "Bearer sesame"

    class BadAuth(TokenAuth):
        def generate_credential(self, cntl):
            return "Bearer wrong"

    sopts = pkg.rpc.ServerOptions()
    sopts.auth = TokenAuth()
    with _Started(pkg, "mem", sopts=sopts, auth=TokenAuth()) as s:
        cntl, resp = _echo(pkg, s.ch, "a")
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "grpc:a"
        bad = s.channel(pkg, auth=BadAuth())
        cntl, _ = _echo(pkg, bad, "b")
        assert cntl.failed()
        assert cntl.error_code == pkg.errors.ERPCAUTH


# ---- TestGrpcWireFixture -------------------------------------------------

def test_pack_request_golden(pkg):
    g = pkg.g2
    cntl = types.SimpleNamespace(remote_side=None,
                                 _pack_socket=_FakeH2Socket())
    out = g.pack_request(pkg.Buf(b"\x0a\x02hi"), cid=7, cntl=cntl,
                         method_full_name="EchoService.Echo")
    assert len(out) == 0
    got = bytes(cntl._pack_socket.sent)
    assert got.startswith(g.PREFACE)
    rest = got[len(g.PREFACE):]
    settings = bytes.fromhex("000000040000000000")
    assert rest.startswith(settings)
    rest = rest[len(settings):]
    hdr_block = bytes.fromhex(
        "8386"
        "44112f4563686f536572766963652f4563686f"
        "4106666162726963"
        "5f166170706c69636174696f6e2f677270632b70726f746f"
        "4002746508747261696c657273")
    hdr_frame = bytes.fromhex("%06x" % len(hdr_block)) + \
        bytes([g.FRAME_HEADERS, g.FLAG_END_HEADERS]) + \
        (1).to_bytes(4, "big") + hdr_block
    assert rest.startswith(hdr_frame), (rest[:60].hex(), hdr_frame.hex())
    rest = rest[len(hdr_frame):]
    msg = b"\x00" + (4).to_bytes(4, "big") + b"\x0a\x02hi"
    data_frame = bytes.fromhex("%06x" % len(msg)) + \
        bytes([g.FRAME_DATA, g.FLAG_END_STREAM]) + \
        (1).to_bytes(4, "big") + msg
    assert rest == data_frame


# ---- TestHpackEncoderGolden -----------------------------------------------

REQ1 = [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
        (b":authority", b"www.example.com")]
REQ2 = REQ1 + [(b"cache-control", b"no-cache")]
REQ3 = [(b":method", b"GET"), (b":scheme", b"https"),
        (b":path", b"/index.html"), (b":authority", b"www.example.com"),
        (b"custom-key", b"custom-value")]
RESP1 = [(b":status", b"302"), (b"cache-control", b"private"),
         (b"date", b"Mon, 21 Oct 2013 20:13:21 GMT"),
         (b"location", b"https://www.example.com")]
RESP2 = [(b":status", b"307"), (b"cache-control", b"private"),
         (b"date", b"Mon, 21 Oct 2013 20:13:21 GMT"),
         (b"location", b"https://www.example.com")]
RESP3 = [(b":status", b"200"), (b"cache-control", b"private"),
         (b"date", b"Mon, 21 Oct 2013 20:13:22 GMT"),
         (b"location", b"https://www.example.com"),
         (b"content-encoding", b"gzip"),
         (b"set-cookie",
          b"foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")]


def test_c3_encode_requests_without_huffman(pkg):
    e = pkg.hpack.Encoder(index=True, use_huffman=False)
    assert e.encode(REQ1) == bytes.fromhex(
        "828684410f7777772e6578616d706c652e636f6d")
    assert e.table_size() == 57
    assert e.encode(REQ2) == bytes.fromhex("828684be58086e6f2d6361636865")
    assert e.table_size() == 110
    assert e.encode(REQ3) == bytes.fromhex(
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565")
    assert e.table_size() == 164


def test_c4_encode_requests_with_huffman(pkg):
    e = pkg.hpack.Encoder(index=True, use_huffman=True)
    assert e.encode(REQ1) == bytes.fromhex(
        "828684418cf1e3c2e5f23a6ba0ab90f4ff")
    assert e.encode(REQ2) == bytes.fromhex("828684be5886a8eb10649cbf")
    assert e.encode(REQ3) == bytes.fromhex(
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf")
    assert e.table_size() == 164


def test_c5_encode_responses_without_huffman(pkg):
    e = pkg.hpack.Encoder(index=True, use_huffman=False, max_table_size=256)
    assert e.encode(RESP1) == bytes.fromhex(
        "4803333032580770726976617465611d4d6f6e2c203231204f63742032"
        "3031332032303a31333a323120474d546e1768747470733a2f2f777777"
        "2e6578616d706c652e636f6d")
    assert e.encode(RESP2) == bytes.fromhex("4803333037c1c0bf")
    assert e.encode(RESP3) == bytes.fromhex(
        "88c1611d4d6f6e2c203231204f637420323031332032303a31333a3232"
        "20474d54c05a04677a69707738666f6f3d4153444a4b48514b425a584f"
        "5157454f50495541585157454f49553b206d61782d6167653d33363030"
        "3b2076657273696f6e3d31")


def test_c6_encode_responses_with_huffman(pkg):
    e = pkg.hpack.Encoder(index=True, use_huffman=True, max_table_size=256)
    assert e.encode(RESP1) == bytes.fromhex(
        "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166"
        "e082a62d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3")
    assert e.encode(RESP2) == bytes.fromhex("4883640effc1c0bf")


def test_encoder_decoder_table_convergence(pkg):
    e = pkg.hpack.Encoder(index=True, use_huffman=True)
    d = pkg.hpack.Decoder()
    for i in range(10):
        hdrs = [(b":method", b"POST"), (b":path", f"/svc/M{i % 3}".encode()),
                (b"x-request-id", f"req-{i}".encode()),
                (b"x-shared", b"constant-value")]
        assert d.decode(e.encode(hdrs)) == hdrs
    assert len(e.encode([(b"x-shared", b"constant-value")])) == 1


# ---- TestHpackIntegerAndLiteralVectors -------------------------------------

def test_c1_integers(pkg):
    h = pkg.hpack
    assert h._encode_int(10, 5, 0) == b"\x0a"
    assert h._encode_int(1337, 5, 0) == b"\x1f\x9a\x0a"
    assert h._encode_int(42, 8, 0) == b"\x2a"
    assert h._decode_int(b"\x0a", 0, 5) == (10, 1)
    assert h._decode_int(b"\x1f\x9a\x0a", 0, 5) == (1337, 3)
    assert h._decode_int(b"\x2a", 0, 8) == (42, 1)


def test_c2_1_literal_with_indexing(pkg):
    d = pkg.hpack.Decoder()
    assert d.decode(bytes.fromhex(
        "400a637573746f6d2d6b65790d637573746f6d2d686561646572")) == \
        [(b"custom-key", b"custom-header")]
    assert len(d.dynamic) == 1


def test_c2_2_literal_without_indexing(pkg):
    d = pkg.hpack.Decoder()
    assert d.decode(bytes.fromhex("040c2f73616d706c652f70617468")) == \
        [(b":path", b"/sample/path")]
    assert len(d.dynamic) == 0


def test_c2_3_literal_never_indexed(pkg):
    d = pkg.hpack.Decoder()
    assert d.decode(bytes.fromhex("100870617373776f726406736563726574")) == \
        [(b"password", b"secret")]
    assert len(d.dynamic) == 0


def test_c2_4_indexed(pkg):
    assert pkg.hpack.Decoder().decode(b"\x82") == [(b":method", b"GET")]


def test_huffman_encode_roundtrip(pkg):
    h = pkg.hpack
    for s in (b"www.example.com", b"no-cache", b"custom-value",
              b"Mon, 21 Oct 2013 20:13:21 GMT", bytes(range(256))):
        assert h.huffman_decode(h.huffman_encode(s)) == s
    assert h.huffman_encode(b"www.example.com") == bytes.fromhex(
        "f1e3c2e5f23a6ba0ab90f4ff")


# ---- TestHpackRfc7541Vectors ----------------------------------------------

def test_c3_requests_without_huffman(pkg):
    d = pkg.hpack.Decoder()
    assert d.decode(bytes.fromhex(
        "828684410f7777772e6578616d706c652e636f6d")) == REQ1
    assert d.decode(bytes.fromhex("828684be58086e6f2d6361636865")) == REQ2
    assert d.decode(bytes.fromhex(
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565")) == \
        REQ3


def test_c4_requests_with_huffman(pkg):
    d = pkg.hpack.Decoder()
    assert d.decode(bytes.fromhex(
        "828684418cf1e3c2e5f23a6ba0ab90f4ff")) == REQ1
    assert d.decode(bytes.fromhex("828684be5886a8eb10649cbf"))[-1] == \
        (b"cache-control", b"no-cache")
    assert d.decode(bytes.fromhex(
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"))[-1] == \
        (b"custom-key", b"custom-value")


def test_c6_responses_with_huffman(pkg):
    d = pkg.hpack.Decoder(max_table_size=256)
    assert d.decode(bytes.fromhex(
        "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166"
        "e082a62d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3")) == RESP1
    assert d.decode(bytes.fromhex("4883640effc1c0bf")) == RESP2


# ---- the curl transcripts (tests/test_foreign_interop.py) --------------------

def _frames(data: bytes, off: int = 0):
    out = []
    while off < len(data):
        ln = int.from_bytes(data[off:off + 3], "big")
        out.append((data[off + 3], data[off + 4],
                    int.from_bytes(data[off + 5:off + 9], "big") & 0x7FFFFFFF,
                    data[off + 9:off + 9 + ln]))
        off += 9 + ln
    return out


def _fixture(name):
    with open(os.path.join(FIXDIR, name), "rb") as f:
        return f.read()


def test_curl_client_to_server_bytes_decode(pkg):
    data = _fixture("h2_curl_c2s.bin")
    assert data[:24] == pkg.g2.PREFACE
    frames = _frames(data, 24)
    assert [f[0] for f in frames] == [4, 8, 1, 0, 4]
    hdrs = dict(pkg.hpack.Decoder().decode(frames[2][3]))
    assert hdrs[b":method"] == b"POST"
    assert hdrs[b":path"] == b"/Echo/Echo"
    assert hdrs[b":scheme"] == b"http"
    assert hdrs[b"content-type"] == b"application/json"
    assert frames[3][1] & 0x1
    assert json.loads(frames[3][3]) == {"message": "from-curl"}


def test_curl_server_to_client_bytes_decode(pkg):
    frames = _frames(_fixture("h2_curl_s2c.bin"))
    assert [f[0] for f in frames] == [4, 4, 8, 8, 1, 0]
    hdrs = dict(pkg.hpack.Decoder().decode(frames[4][3]))
    assert hdrs[b":status"] == b"200"
    assert json.loads(frames[5][3])["message"] == "srv:from-curl"
    assert frames[5][1] & 0x1


def test_curl_transcript_replayed_into_each_server(pkg):
    """The nghttp2-authored request bytes parsed by the package's server
    side: the stream ids, headers and body the transcript states, and an
    answer with the response the s2c transcript carries."""
    g = pkg.g2

    class Echo(pkg.rpc.Service):
        SERVICE_NAME = "Echo"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            response.message = "srv:" + request.message
            done()

    server = pkg.rpc.Server()
    server.add_service(Echo())
    sock = _FakeH2Socket()
    arg = types.SimpleNamespace(server=server)
    result = g.parse(pkg.Buf(_fixture("h2_curl_c2s.bin")), sock, False, arg)
    calls = result.message
    assert [c.stream.stream_id for c in calls] == [1]
    st = calls[0].stream
    assert st.header(b":path") == b"/Echo/Echo"
    assert st.header(b"content-type") == b"application/json"
    assert json.loads(bytes(st.data)) == {"message": "from-curl"}
    sock.sent.clear()
    g.process_request(calls, sock, server)
    frames = sock.drain_frames()
    want = _frames(_fixture("h2_curl_s2c.bin"))
    dec = pkg.hpack.Decoder()
    hdrs = dict(dec.decode(frames[0][3]))
    assert hdrs[b":status"] == dict(pkg.hpack.Decoder().decode(
        want[4][3]))[b":status"]
    assert frames[-1][2] == want[5][2] == 1
    assert json.loads(frames[-1][3]) == json.loads(want[5][3])


# ---- what the port adds -------------------------------------------------

def _server_frames(p, calls_pb, status=0, message=""):
    """The frames one package's server half writes for a gRPC response."""
    sock, conn = _server_conn(p)
    conn.settings_sent = True
    for sid, pb in calls_pb:
        p.g2._send_grpc_response(sock, sid, pb, status, message)
    return bytes(sock.sent)


def test_response_frames_equal_the_jax_package():
    """The server half writes the JAX package's bytes: a response, an
    error status, and a response parked behind the window."""
    for calls, status, msg in (([(1, b"\x0a\x02ok")], 0, ""),
                               ([(3, None)], 13, "boom"),
                               ([(1, b"q" * 100_000)], 0, ""),
                               ([(1, b"a"), (3, b"b"), (5, b"c")], 0, "")):
        assert _server_frames(PORT, calls, status, msg) == \
            _server_frames(JAX, calls, status, msg)


def test_request_frames_equal_the_jax_package():
    """Ten requests packed on one connection (the dynamic table evolving)
    are the JAX package's bytes, timeout header and credential included."""
    outs = []
    for p in (JAX, PORT):
        sock = _FakeH2Socket()
        for i in range(10):
            cntl = types.SimpleNamespace(
                remote_side="h:1", _pack_socket=sock, auth_token="t%d" % i,
                timeout_ms=250 * (i + 1), _start_us=0)
            p.g2.pack_request(p.Buf(b"x" * (i * 700)), i, cntl,
                              f"Svc{i % 3}.M{i % 2}")
        outs.append(bytes(sock.sent))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_cross_package_grpc(client, server):
    """Each package's gRPC client against the other's server over TCP: 20
    echoes (one of 300 kB, across the flow-control window), an error
    status and an unknown method map to the same codes, and the server's
    reply bytes equal its twin's."""
    c, s = PKGS[client], PKGS[server]
    with _Started(s, "tcp") as srv:
        ch = c.rpc.Channel()
        ch.init(srv.target, options=c.rpc.ChannelOptions(
            protocol="grpc", timeout_ms=10000))
        try:
            for i in range(20):
                msg = f"m{i}" + ("z" * 300_000 if i == 7 else "")
                cntl, resp = _echo(c, ch, msg)
                assert not cntl.failed(), cntl.error_text
                assert resp.message == "grpc:" + msg
            cntl = c.rpc.Controller()
            ch.call_method("EchoService.Fail", cntl, c.Req(message="x"),
                           c.Resp)
            assert cntl.error_code == c.errors.EINTERNAL
            assert "grpc boom" in cntl.error_text
            cntl = c.rpc.Controller()
            ch.call_method("EchoService.Nope", cntl, c.Req(message="x"),
                           c.Resp)
            assert cntl.error_code == c.errors.ENOMETHOD
        finally:
            ch.close()
    twin = [_server_frames(p, [(1, p.Resp(message="grpc:m").
                                SerializeToString())]) for p in (c, s)]
    assert twin[0] == twin[1]


def test_stop_with_calls_in_flight_sends_goaway():
    """A stop with 8 calls in flight on one h2 connection: the client
    reads the GOAWAY naming the last stream the server took, the streams
    above it fail at once with EAGAIN, the others when the connection
    closes, every code retryable, and no call waits out its deadline."""
    gate = threading.Event()
    entered = []

    class Slow(trpc.Service):
        SERVICE_NAME = "EchoService"

        @trpc.method(TReq, TResp)
        def Echo(self, cntl, request, response, done):
            entered.append(1)
            # a handler that blocks counts its wait, or eight of them
            # would hold every scheduler worker, the client's included
            tsched.note_worker_blocked()
            try:
                gate.wait(10)
            finally:
                tsched.note_worker_unblocked()
            response.message = "late"
            done()

    seen = []
    orig = tg2._on_goaway

    def spy(conn, socket, last_sid):
        seen.append(last_sid)
        orig(conn, socket, last_sid)

    tg2._on_goaway = spy
    try:
        with _Started(PORT, "tcp", service=Slow(), timeout_ms=20000,
                      max_retry=0) as s:
            done = []
            cntls = []
            for i in range(8):
                cntl = trpc.Controller()
                cntls.append(cntl)
                s.ch.call_method("EchoService.Echo", cntl,
                                 TReq(message=str(i)), TResp,
                                 done=lambda c: done.append(c))
            deadline = time.monotonic() + 10
            while not entered and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.1)            # every stream reached the server
            t0 = time.monotonic()
            s.server.stop()
            while len(done) < 8 and time.monotonic() < t0 + 10:
                time.sleep(0.01)
            assert len(done) == 8, f"{8 - len(done)} calls hung"
            assert time.monotonic() - t0 < 5
            assert seen and 1 <= seen[0] <= 15
            # the handlers that started hold their streams at or below
            # the GOAWAY's last stream id; the rest were never taken
            refused = sum(c.error_code == trpc.errors.EAGAIN for c in cntls)
            assert refused == (15 - seen[0]) // 2, (seen, refused)
            for c in cntls:
                assert c.failed()
                assert trpc.Controller._retryable(c.error_code), \
                    (c.error_code, c.error_text)
    finally:
        tg2._on_goaway = orig
        gate.set()


def test_deadline_spent_fails_deadline_exceeded():
    """A 1 ms budget against a slow handler: the client fails ERPCTIMEDOUT
    (gRPC's DEADLINE_EXCEEDED), and the server answers a raw request whose
    grpc-timeout is spent with grpc-status 4, not a late OK."""
    class Slow(trpc.Service):
        SERVICE_NAME = "EchoService"

        @trpc.method(TReq, TResp)
        def Echo(self, cntl, request, response, done):
            time.sleep(0.05)
            response.message = "late"
            done()

    with _Started(PORT, "tcp", service=Slow(), max_retry=0) as s:
        cntl = trpc.Controller()
        cntl.timeout_ms = 1
        _echo(PORT, s.ch, "x", cntl)
        assert cntl.error_code == trpc.errors.ERPCTIMEDOUT
        sock, conn = _server_conn(PORT)
        block = thpack.Encoder(index=False).encode(
            [(b":method", b"POST"), (b":path", b"/EchoService/Echo"),
             (b"content-type", b"application/grpc"),
             (b"grpc-timeout", b"1m")])
        wire = (tg2.PREFACE + tg2.frame(tg2.FRAME_SETTINGS, 0, 0, b"")
                + tg2.frame(tg2.FRAME_HEADERS, tg2.FLAG_END_HEADERS, 1,
                            block)
                + tg2.frame(tg2.FRAME_DATA, tg2.FLAG_END_STREAM, 1,
                            tg2.grpc_message(TReq(message="r")
                                             .SerializeToString())))
        sock = _FakeH2Socket()
        arg = types.SimpleNamespace(server=s.server)
        calls = tg2.parse(TBuf(wire), sock, False, arg).message
        sock.sent.clear()
        tg2.process_request(calls, sock, s.server)
        dec = thpack.Decoder()
        trailers = {}
        for ftype, _f, _sid, payload in sock.drain_frames():
            if ftype == tg2.FRAME_HEADERS:
                trailers.update(dec.decode(payload))
        assert trailers[b"grpc-status"] == b"%d" % tg2.GRPC_DEADLINE_EXCEEDED


@pytest.mark.parametrize("ctype", [tcompress.COMPRESS_TYPE_GZIP,
                                   tcompress.COMPRESS_TYPE_ZLIB])
@pytest.mark.parametrize("protocol", ["grpc", "tpu_std"])
def test_compressed_calls_with_a_credential(protocol, ctype):
    """A compressed body and an HMAC credential, on gRPC (the compressed
    flag with grpc-encoding) and on tpu_std (compress_type in the meta):
    the answer is right, and the wrong key fails ERPCAUTH."""
    sopts = trpc.ServerOptions()
    sopts.auth = tauth.HmacAuthenticator("sesame")
    server = trpc.Server(sopts)
    server.add_service(_echo_service(PORT))
    assert server.start("127.0.0.1:0") == 0
    chans = []
    try:
        for key, ok in (("sesame", True), ("wrong", False)):
            ch = trpc.Channel()
            ch.init(f"127.0.0.1:{server.listen_port}",
                    options=trpc.ChannelOptions(
                        protocol=protocol, timeout_ms=5000, max_retry=0,
                        auth=tauth.HmacAuthenticator(key)))
            chans.append(ch)
            cntl = trpc.Controller()
            cntl.compress_type = ctype
            msg = "compress me " * 500
            cntl, resp = _echo(PORT, ch, msg, cntl)
            if ok:
                assert not cntl.failed(), cntl.error_text
                assert resp.message == "grpc:" + msg
            else:
                assert cntl.error_code == trpc.errors.ERPCAUTH
    finally:
        for ch in chans:
            ch.close()
        server.stop()


def test_compressed_grpc_body_is_compressed_on_the_wire():
    """The DATA frame of a compressed call carries the compressed flag and
    a gzip body that is smaller than the message."""
    sock = _FakeH2Socket()
    cntl = types.SimpleNamespace(remote_side=None, _pack_socket=sock,
                                 compress_type=tcompress.COMPRESS_TYPE_GZIP)
    body = TReq(message="z" * 10_000).SerializeToString()
    tg2.pack_request(TBuf(body), 1, cntl, "EchoService.Echo")
    frames = _frames(bytes(sock.sent), len(tg2.PREFACE))
    hdrs = dict(thpack.Decoder().decode(frames[1][3]))
    assert hdrs[b"grpc-encoding"] == b"gzip"
    data = frames[2][3]
    assert data[0] == 1 and len(data) < len(body)
    assert tcompress.decompress(tcompress.COMPRESS_TYPE_GZIP, data[5:]) == \
        body


def test_authenticated_ici_server_verifies_every_call():
    """A server with an authenticator opens no native door (the door has
    no verify hook): every call on ``ici://`` reaches the Python plane's
    check, with a credential or without."""
    from brpc_tpu_torch.ici.mesh import IciMesh
    prev = IciMesh._default
    IciMesh.set_default(IciMesh(8, device="cpu"))
    sopts = trpc.ServerOptions()
    sopts.auth = tauth.HmacAuthenticator("sesame")
    server = trpc.Server(sopts)
    server.add_service(_echo_service(PORT))
    chans = []
    try:
        assert server.start("ici://3") == 0
        assert server._native_ici is None
        for auth, want in ((tauth.HmacAuthenticator("sesame"), 0),
                           (None, trpc.errors.ERPCAUTH),
                           (tauth.HmacAuthenticator("wrong"),
                            trpc.errors.ERPCAUTH)):
            ch = trpc.Channel()
            ch.init("ici://3", options=trpc.ChannelOptions(
                timeout_ms=5000, max_retry=0, auth=auth))
            chans.append(ch)
            cntl, _ = _echo(PORT, ch, "i")
            assert cntl.error_code == want, cntl.error_text
    finally:
        for ch in chans:
            ch.close()
        server.stop()
        IciMesh.set_default(prev)
