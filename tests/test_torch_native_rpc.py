"""The native TCP datapath on both packages: the JAX package's C++ core
(``native/rpc.cpp`` with ``brpc_tpu.rpc.native_fabric``) and the port's own
(``brpc_tpu_torch/csrc/rpc_native.cpp`` with
``brpc_tpu_torch.rpc.native_fabric``).

Each case of ``tests/test_native_rpc.py`` runs over four pairings of one
wire: the port's native channel against the port's native server, the JAX
package's native channel against the port's native server, the port's native
channel against the JAX package's native server, and the JAX package's
against its own.  Interop with each package's Python stack (a ``tcp://``
``rpc.Channel`` to a native server, a native channel to an ``rpc.Server``)
runs per package.  Request and response frames are held byte for byte
against the JAX core's, read off raw sockets.  The bench entries keep the
JAX test's bounds.
"""
from __future__ import annotations

import socket as pysock
import threading
import time

import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import native as jnative
from brpc_tpu.rpc import native_fabric as jnf
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.bthread import scheduler as tsched
from brpc_tpu_torch.butil import native as tnative
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import native_fabric as tnf
from brpc_tpu_torch.proto.echo_pb2 import (EchoRequest as TReq,
                                           EchoResponse as TResp)
from tests.echo_pb2 import EchoRequest as JReq, EchoResponse as JResp
from tests.torch_procs import jax_core_available

pytestmark = pytest.mark.skipif(
    not (jax_core_available() and tnative.available()),
    reason="a native core is unavailable")


class _Pkg:
    def __init__(self, name, rpc, nf, Req, Resp):
        self.name, self.rpc, self.nf = name, rpc, nf
        self.Req, self.Resp = Req, Resp


PORT = _Pkg("port", trpc, tnf, TReq, TResp)
JAX = _Pkg("jax", jrpc, jnf, JReq, JResp)
# (server package, channel package)
PAIRS = {"port-port": (PORT, PORT), "jax-chan-port-server": (PORT, JAX),
         "port-chan-jax-server": (JAX, PORT), "jax-jax": (JAX, JAX)}


@pytest.fixture(params=list(PAIRS))
def pair(request):
    return PAIRS[request.param]


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PORT if request.param == "port" else JAX


def _echo_service(p):
    rpc, errs = p.rpc, p.rpc.errors

    class EchoService(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(p.Req, p.Resp)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            if len(cntl.request_attachment):
                cntl.response_attachment.append(cntl.request_attachment)
            done()

        @rpc.method(p.Req, p.Resp)
        def Fail(self, cntl, request, response, done):
            cntl.set_failed(errs.EINTERNAL, "deliberate")
            done()

        @rpc.method(p.Req, p.Resp)
        def Slow(self, cntl, request, response, done):
            time.sleep((request.sleep_us or 0) / 1e6)
            response.message = "slow"
            done()

    return EchoService()


def _serve(p, svc=None, echo=(), **kw):
    server = p.nf.NativeServer(**kw)
    if svc is not None:
        server.add_service(svc)
    for m in echo:
        server.register_native_echo(m)
    return server, server.start(0)


def _channel(p, port, pooled=0):
    if pooled:
        ch = p.nf.NativePooledChannel()
        ch.init(f"127.0.0.1:{port}", nconns=pooled)
    else:
        ch = p.nf.NativeChannel()
        ch.init(f"127.0.0.1:{port}")
    return ch


def test_native_to_native_echo(pair):
    sp, cp = pair
    server, port = _serve(sp, echo=["EchoService.Echo"])
    ch = _channel(cp, port)
    try:
        cntl = cp.rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              cp.Req(message="hello-native"), cp.Resp)
        assert not cntl.failed(), cntl.error_text_
        assert resp.message == "hello-native"
        assert server.requests() == 1
    finally:
        ch.close()
        server.stop()


def test_native_server_python_service(pair):
    sp, cp = pair
    server, port = _serve(sp, _echo_service(sp))
    ch = _channel(cp, port)
    try:
        cntl = cp.rpc.Controller()
        cntl.request_attachment.append(b"att-bytes")
        resp = ch.call_method("EchoService.Echo", cntl,
                              cp.Req(message="py-handler"), cp.Resp)
        assert not cntl.failed(), cntl.error_text_
        assert resp.message == "py-handler"
        assert cntl.response_attachment.to_bytes() == b"att-bytes"
        cntl2 = cp.rpc.Controller()
        ch.call_method("EchoService.Fail", cntl2, cp.Req(message="x"),
                       cp.Resp)
        assert cntl2.failed()
        assert cntl2.error_code_ == errors.EINTERNAL
        assert "deliberate" in cntl2.error_text_
    finally:
        ch.close()
        server.stop()


def test_native_server_no_method(pair):
    sp, cp = pair
    server, port = _serve(sp, _echo_service(sp))
    ch = _channel(cp, port)
    try:
        cntl = cp.rpc.Controller()
        ch.call_method("EchoService.Nope", cntl, cp.Req(message="x"),
                       cp.Resp)
        assert cntl.failed()
        assert cntl.error_code_ == errors.ENOMETHOD
        assert cntl.error_text_ == "no method EchoService.Nope"
    finally:
        ch.close()
        server.stop()


def test_native_channel_timeout(pair):
    sp, cp = pair
    server, port = _serve(sp, _echo_service(sp))
    ch = _channel(cp, port)
    try:
        cntl = cp.rpc.Controller()
        cntl.timeout_ms = 50
        ch.call_method("EchoService.Slow", cntl,
                       cp.Req(message="x", sleep_us=300_000), cp.Resp)
        assert cntl.failed()
        assert cntl.error_code_ == errors.ERPCTIMEDOUT
    finally:
        ch.close()
        server.stop()


def test_python_channel_to_native_server(pkg):
    """Each package's tcp:// ``rpc.Channel`` (tpu_std framing, the
    protobuf-encoded meta) against the port's native frame parser."""
    server, port = _serve(PORT, _echo_service(PORT),
                          echo=["NativeEcho.Echo"])
    try:
        ch = pkg.rpc.Channel()
        ch.init(f"tcp://127.0.0.1:{port}",
                options=pkg.rpc.ChannelOptions(timeout_ms=5000,
                                               max_retry=0))
        cntl = pkg.rpc.Controller()
        cntl.request_attachment.append(b"pyatt")
        resp = ch.call_method("EchoService.Echo", cntl,
                              pkg.Req(message="from-python"), pkg.Resp)
        assert not cntl.failed(), cntl.error_text_
        assert resp.message == "from-python"
        assert cntl.response_attachment.to_bytes() == b"pyatt"
        cntl2 = pkg.rpc.Controller()
        resp2 = ch.call_method("NativeEcho.Echo", cntl2,
                               pkg.Req(message="native-tier"), pkg.Resp)
        assert not cntl2.failed(), cntl2.error_text_
        assert resp2.message == "native-tier"
        ch.close()
    finally:
        server.stop()


def test_native_channel_to_python_server(pkg):
    """The port's native channel's meta parsed by each package's Python
    ``rpc.Server``."""
    opts = pkg.rpc.ServerOptions()
    opts.usercode_inline = True
    server = pkg.rpc.Server(opts)
    server.add_service(_echo_service(pkg))
    server.start("127.0.0.1:0")
    ch = _channel(PORT, server.listen_port)
    try:
        cntl = trpc.Controller()
        cntl.request_attachment.append(b"natt")
        resp = ch.call_method("EchoService.Echo", cntl,
                              TReq(message="from-native"), TResp)
        assert not cntl.failed(), cntl.error_text_
        assert resp.message == "from-native"
        assert cntl.response_attachment.to_bytes() == b"natt"
    finally:
        ch.close()
        server.stop()


def _read_frame(s) -> bytes:
    hdr = b""
    while len(hdr) < 12:
        got = s.recv(12 - len(hdr))
        assert got, "peer closed mid-header"
        hdr += got
    assert hdr[:4] == b"TRPC"
    n = int.from_bytes(hdr[4:8], "big") + int.from_bytes(hdr[8:12], "big")
    rest = b""
    while len(rest) < n:
        got = s.recv(n - len(rest))
        assert got, "peer closed mid-frame"
        rest += got
    return hdr + rest


def _raw_exchange(port, frame) -> bytes:
    s = pysock.create_connection(("127.0.0.1", port))
    try:
        s.sendall(frame)
        return _read_frame(s)
    finally:
        s.close()


def test_meta_codec_matches_python_protobuf(pkg):
    """A protobuf-encoded meta carrying stream_settings (a field the C++
    parser skips) is answered by the port's native server, and the
    response meta parses with protobuf."""
    from brpc_tpu_torch.proto import rpc_meta_pb2 as meta_pb
    server, port = _serve(PORT, _echo_service(PORT))
    try:
        meta = meta_pb.RpcMeta()
        meta.request.service_name = "EchoService"
        meta.request.method_name = "Echo"
        meta.correlation_id = 77
        meta.stream_settings.stream_id = 5
        meta.stream_settings.frame_type = 4
        body = pkg.Req(message="skipfield").SerializeToString()
        mb = meta.SerializeToString()
        frame = (b"TRPC" + len(mb).to_bytes(4, "big")
                 + len(body).to_bytes(4, "big") + mb + body)
        out = _raw_exchange(port, frame)
        msize = int.from_bytes(out[4:8], "big")
        rmeta = meta_pb.RpcMeta()
        rmeta.ParseFromString(out[12:12 + msize])
        assert rmeta.correlation_id == 77
        assert rmeta.response.error_code == 0
        resp = pkg.Resp()
        resp.ParseFromString(out[12 + msize:])
        assert resp.message == "skipfield"
    finally:
        server.stop()


def _request_frame_of(p, att=b"", method="EchoService.Echo") -> bytes:
    """The first request frame ``p``'s native channel writes, read off a
    raw listening socket that answers nothing (the call times out)."""
    lst = pysock.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    got = {}

    def accept():
        conn, _ = lst.accept()
        got["frame"] = _read_frame(conn)
        got["conn"] = conn
    t = threading.Thread(target=accept, daemon=True)
    t.start()
    ch = _channel(p, lst.getsockname()[1])
    try:
        cntl = p.rpc.Controller()
        cntl.timeout_ms = 300
        if att:
            cntl.request_attachment.append(att)
        ch.call_method(method, cntl,
                       p.Req(message="frame-bytes", sleep_us=7), p.Resp)
        assert cntl.error_code_ == errors.ERPCTIMEDOUT
        t.join(5)
    finally:
        ch.close()
        got.get("conn") and got["conn"].close()
        lst.close()
    return got["frame"]


@pytest.mark.parametrize("att", [b"", b"attachment-bytes"])
def test_frames_byte_equal_to_the_jax_core(att):
    """Request frames of the two native channels, and response frames of
    the two native servers (the C++ echo tier, a Python handler, a handler
    error and a missing method) to one request, are the same bytes."""
    methods = ("NativeEcho.Echo", "EchoService.Echo", "EchoService.Fail",
               "EchoService.Nope")
    reqs = {m: _request_frame_of(PORT, att, m) for m in methods}
    for m in methods:
        assert reqs[m] == _request_frame_of(JAX, att, m), m
    replies = {}
    for p in (PORT, JAX):
        server, port = _serve(p, _echo_service(p),
                              echo=["NativeEcho.Echo"])
        try:
            for m in methods:
                replies.setdefault(m, []).append(
                    _raw_exchange(port, reqs[m]))
        finally:
            server.stop()
    for method, (tport, tjax) in replies.items():
        assert tport == tjax, method
    assert replies["EchoService.Echo"][0].endswith(att)


def test_native_concurrent_calls(pair):
    sp, cp = pair
    server, port = _serve(sp, _echo_service(sp))
    ch = _channel(cp, port)
    failures = []

    def worker(i):
        for j in range(20):
            cntl = cp.rpc.Controller()
            msg = f"w{i}-{j}"
            resp = ch.call_method("EchoService.Echo", cntl,
                                  cp.Req(message=msg), cp.Resp)
            if cntl.failed() or resp.message != msg:
                failures.append((i, j, cntl.error_text_))
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not failures, failures[:3]
        assert server.requests() == 160
    finally:
        ch.close()
        server.stop()


def test_native_rpc_bench_entries():
    """The port's entries, with the JAX test's bounds."""
    p50 = tnative.native_rpc_echo_p50_us(iters=300, payload=1024)
    assert p50 > 0, "bench entry failed"
    assert p50 < 2000
    qps = tnative.native_rpc_qps(threads=4, duration_ms=300, payload=64)
    assert qps > 1000
    assert tnative.native_echo_p50_us(iters=300, payload=1024) > 0
    for gbps in (tnative.native_rpc_throughput_gbps(1, 200, 1 << 20),
                 tnative.native_pooled_throughput_gbps(2, 2, 200, 1 << 20),
                 tnative.native_async_throughput_gbps(4, 200, 256 << 10)):
        assert gbps > 0


def test_native_async_call(pair):
    sp, cp = pair
    server, port = _serve(sp, _echo_service(sp))
    ch = _channel(cp, port)
    try:
        seen = []
        ev = threading.Event()

        def done(cntl):
            seen.append((cntl.failed(), cntl.response))
            ev.set()

        cntl = cp.rpc.Controller()
        cntl.timeout_ms = 5000
        fut = ch.call_method_async("EchoService.Echo", cntl,
                                   cp.Req(message="async-hi"), cp.Resp,
                                   done=done)
        assert fut.wait(10)
        assert fut.done()
        assert ev.wait(5)
        assert seen[0][0] is False and len(seen) == 1
        assert fut.response.message == "async-hi"
        futs = []
        for i in range(8):
            c = cp.rpc.Controller()
            c.timeout_ms = 5000
            futs.append((i, ch.call_method_async(
                "EchoService.Echo", c, cp.Req(message=f"a{i}"), cp.Resp)))
        for i, f in futs:
            assert f.wait(10), f"async call {i} never completed"
            assert not f.cntl.failed(), f.cntl.error_text
            assert f.response.message == f"a{i}"
        assert not cp.nf._inflight_futures
    finally:
        ch.close()
        server.stop()


def test_native_async_timeout(pair):
    sp, cp = pair

    class BlackHole(sp.rpc.Service):
        SERVICE_NAME = "EchoService"

        @sp.rpc.method(sp.Req, sp.Resp)
        def Echo(self, cntl, request, response, done):
            pass                        # never calls done()

    server, port = _serve(sp, BlackHole())
    ch = _channel(cp, port)
    try:
        cntl = cp.rpc.Controller()
        cntl.timeout_ms = 200
        fut = ch.call_method_async("EchoService.Echo", cntl,
                                   cp.Req(message="x"), cp.Resp)
        assert fut.wait(10)
        assert fut.cntl.failed()
        assert fut.cntl.error_code_ == errors.ERPCTIMEDOUT
    finally:
        ch.close()
        server.stop()


def test_native_pooled_channel(pair):
    sp, cp = pair
    server, port = _serve(sp, _echo_service(sp))
    pool = _channel(cp, port, pooled=3)
    errs = []
    try:
        def worker(wid):
            try:
                for i in range(10):
                    cntl = cp.rpc.Controller()
                    cntl.timeout_ms = 5000
                    resp = pool.call_method(
                        "EchoService.Echo", cntl,
                        cp.Req(message=f"p{wid}-{i}"), cp.Resp)
                    assert not cntl.failed(), cntl.error_text
                    assert resp.message == f"p{wid}-{i}"
            except Exception as e:   # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        assert server.requests() == 40
    finally:
        pool.close()
        server.stop()


def test_native_server_tasklet_dispatch():
    """usercode_inline=False parks the port's handlers on the port's
    scheduler tasklets instead of the epoll loop."""
    where = {}

    class Probe(trpc.Service):
        SERVICE_NAME = "EchoService"

        @trpc.method(TReq, TResp)
        def Echo(self, cntl, request, response, done):
            where["tasklet"] = tsched.current_tasklet() is not None
            response.message = request.message
            done()

    server, port = _serve(PORT, Probe(), usercode_inline=False)
    ch = _channel(JAX, port)
    try:
        cntl = jrpc.Controller()
        cntl.timeout_ms = 5000
        resp = ch.call_method("EchoService.Echo", cntl,
                              JReq(message="t"), JResp)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "t"
        assert where["tasklet"] is True
    finally:
        ch.close()
        server.stop()


def test_handler_raise_gets_the_last_resort_reply(pair):
    """A handler that raises before done() answers EINTERNAL with the
    exception's text; the connection keeps serving."""
    sp, cp = pair

    class Raiser(sp.rpc.Service):
        SERVICE_NAME = "EchoService"

        @sp.rpc.method(sp.Req, sp.Resp)
        def Echo(self, cntl, request, response, done):
            raise ValueError("boom")

    server, port = _serve(sp, Raiser(), echo=["NativeEcho.Echo"])
    ch = _channel(cp, port)
    try:
        cntl = cp.rpc.Controller()
        ch.call_method("EchoService.Echo", cntl, cp.Req(message="x"),
                       cp.Resp)
        assert cntl.error_code_ == errors.EINTERNAL
        assert "ValueError: boom" in cntl.error_text_
        cntl = cp.rpc.Controller()
        resp = ch.call_method("NativeEcho.Echo", cntl,
                              cp.Req(message="after"), cp.Resp)
        assert not cntl.failed() and resp.message == "after"
    finally:
        ch.close()
        server.stop()


def test_stop_fails_inflight_calls():
    """A native server stopped under 8 parked calls: every caller returns
    with an error code, and the same code on both packages' servers."""
    codes = {}
    for sp in (PORT, JAX):
        gate = threading.Event()

        class Park(sp.rpc.Service):
            SERVICE_NAME = "EchoService"

            @sp.rpc.method(sp.Req, sp.Resp)
            def Echo(self, cntl, request, response, done):
                sp_done = done
                threading.Thread(
                    target=lambda: (gate.wait(5), sp_done()),
                    daemon=True).start()

        server, port = _serve(sp, Park())
        ch = _channel(PORT, port)
        futs = []
        for i in range(8):
            c = trpc.Controller()
            c.timeout_ms = 5000
            futs.append(ch.call_method_async("EchoService.Echo", c,
                                             TReq(message=str(i)), TResp))
        deadline = time.monotonic() + 5
        while server.requests() < 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        server.stop()
        assert all(f.wait(10) for f in futs)
        codes[sp.name] = sorted(f.cntl.error_code_ for f in futs)
        gate.set()
        ch.close()
    assert codes["port"] == codes["jax"]
    assert all(c != 0 for c in codes["port"]), codes
