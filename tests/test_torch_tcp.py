"""TCP on both packages (``brpc_tpu.rpc.tcp_transport`` and
``brpc_tpu_torch.rpc.tcp_transport``): the echo of ``tests/test_rpc_echo.py::
TestTcpEcho``, the idle reaper and ``internal_port`` of
``tests/test_misc_features.py:146-345``, ``connect_timeout_ms``, the
stream's TCP leg and the IOBuf fd calls, each held to the same bytes and
codes; then a cross-process TCP echo with a fresh interpreter as the
server.
"""
from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil.iobuf import IOBuf as JBuf, IOPortal as JPortal
from brpc_tpu.rpc import tcp_transport as jtcp
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf, IOPortal as TPortal
from brpc_tpu_torch.ici.mesh import IciMesh as TMesh
from brpc_tpu_torch.proto.echo_pb2 import (EchoRequest as TReq,
                                           EchoResponse as TResp)
from brpc_tpu_torch.rpc import errors as terrors
from brpc_tpu_torch.rpc import tcp_transport as ttcp
from tests.echo_pb2 import EchoRequest as JReq, EchoResponse as JResp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, tcp=jtcp, Req=JReq,
                            Resp=JResp, Buf=JBuf, Portal=JPortal)
PORT = types.SimpleNamespace(name="port", rpc=trpc, tcp=ttcp, Req=TReq,
                             Resp=TResp, Buf=TBuf, Portal=TPortal)


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return JAX if request.param == "jax" else PORT


@pytest.fixture(scope="module", autouse=True)
def _drain_sockets():
    yield
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and list_sockets():
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()


def _echo_service(pkg):
    class EchoService(pkg.rpc.Service):
        def __init__(self):
            self.calls = 0

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            self.calls += 1
            if request.sleep_us:
                time.sleep(request.sleep_us / 1e6)
            response.message = request.message
            if len(cntl.request_attachment):
                cntl.response_attachment.append(cntl.request_attachment)
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


def _channel(pkg, target, **opts):
    ch = pkg.rpc.Channel()
    ch.init(target, options=pkg.rpc.ChannelOptions(**opts))
    return ch


def _call(pkg, ch, msg="", att=None, sleep_us=0):
    cntl = pkg.rpc.Controller()
    if att is not None:
        cntl.request_attachment.append(att)
    resp = ch.call_method("EchoService.Echo", cntl,
                          pkg.Req(message=msg, sleep_us=sleep_us), pkg.Resp)
    return cntl, resp


def test_sync_echo_over_tcp(pkg):
    server = _server(pkg)
    try:
        assert server.listen_port > 0
        ch = _channel(pkg, f"127.0.0.1:{server.listen_port}")
        cntl, resp = _call(pkg, ch, "over-tcp", att=b"a" * 5000)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "over-tcp"
        assert cntl.response_attachment.to_bytes() == b"a" * 5000
        ch.close()
    finally:
        server.stop()


def test_large_payload_tcp(pkg):
    """8 MiB each way: the writes outgrow the kernel's socket buffer, so
    KeepWrite waits on EPOLLOUT from the event dispatcher."""
    server = _server(pkg)
    try:
        ch = _channel(pkg, f"tcp://127.0.0.1:{server.listen_port}",
                      timeout_ms=20000)
        big = bytes(range(256)) * (32 * 1024)
        cntl, resp = _call(pkg, ch, "x" * (2 << 20), att=big)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "x" * (2 << 20)
        assert cntl.response_attachment.to_bytes() == big
        ch.close()
    finally:
        server.stop()


def test_server_stop_fails_inflight_cleanly(pkg):
    server = _server(pkg)
    ch = _channel(pkg, f"127.0.0.1:{server.listen_port}", timeout_ms=2000,
                  max_retry=0)
    cntl = pkg.rpc.Controller()
    done = threading.Event()
    ch.call_method("EchoService.Echo", cntl,
                   pkg.Req(message="x", sleep_us=300_000), pkg.Resp,
                   lambda c: done.set())
    time.sleep(0.05)
    server.stop()
    assert done.wait(10)
    e = pkg.rpc.errors
    assert cntl.error_code in (0, e.EFAILEDSOCKET, e.EEOF, e.ELOGOFF,
                               e.ECONNRESET)
    ch.close()


def test_device_attachment_crosses_tcp_as_host_bytes():
    """The DCN path: a DEVICE attachment is one device-to-host copy on the
    way out, host bytes on the wire, host bytes at the server."""
    mesh = TMesh(ranks=8, device="cpu")
    seen = []

    class Sink(trpc.Service):
        @trpc.method(TReq, TResp)
        def Echo(self, cntl, request, response, done):
            seen.append([r.block.kind for r in
                         cntl.request_attachment._refs])
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = trpc.Server()
    server.add_service(Sink())
    assert server.start("127.0.0.1:0") == 0
    try:
        ch = _channel(PORT, f"127.0.0.1:{server.listen_port}")
        t = mesh.device_put(torch.arange(70000).to(torch.uint8), 1)
        cntl = trpc.Controller()
        cntl.request_attachment.append_device_array(t)
        ch.call_method("Sink.Echo", cntl, TReq(message="d"), TResp)
        assert not cntl.failed(), cntl.error_text
        assert cntl.response_attachment.to_bytes() == bytes(t.numpy())
        from brpc_tpu_torch.butil.iobuf import DEVICE
        assert seen and DEVICE not in seen[0]
        assert not cntl.response_attachment.device_refs()
        ch.close()
    finally:
        server.stop()


def _reaped(pkg):
    """Serve one call on a server with idle_timeout_s=1; returns the
    reaped connection's code, the client socket's code and whether a
    fresh call afterwards succeeded."""
    server = _server(pkg, idle_timeout_s=1)
    try:
        ch = _channel(pkg, f"127.0.0.1:{server.listen_port}",
                      timeout_ms=5000)
        cntl, resp = _call(pkg, ch, "a")
        assert not cntl.failed() and resp.message == "a"
        conns = server.connections()
        assert len(conns) == 1
        smap = pkg.rpc.socket_map.SocketMap.instance()
        client = [e.socket for (ep, _), e in smap._map.items()
                  if ep.port == server.listen_port][0]
        deadline = time.monotonic() + 6
        while (server.connections() or not client.failed) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not server.connections(), "idle connection not reaped"
        cntl, resp = _call(pkg, ch, "b")
        ok = not cntl.failed() and resp.message == "b"
        ch.close()
        return conns[0].failed_error, client.failed_error, ok
    finally:
        server.stop()


def test_idle_reap_codes_equal_jax():
    jax_codes = _reaped(JAX)
    port_codes = _reaped(PORT)
    assert port_codes == jax_codes
    assert port_codes[0] == terrors.ECLOSE and port_codes[2]


def test_server_restart_keeps_idle_reaper_alive():
    server = _server(PORT, idle_timeout_s=1)
    server.stop()
    assert server.start("127.0.0.1:0") == 0
    try:
        assert server.is_running()
        ch = _channel(PORT, f"127.0.0.1:{server.listen_port}",
                      timeout_ms=5000)
        cntl, _ = _call(PORT, ch, "x")
        assert not cntl.failed(), cntl.error_text
        deadline = time.monotonic() + 6
        while server.connections() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not server.connections(), "reaper dead after restart"
        ch.close()
    finally:
        server.stop()


def _internal_refusal(pkg):
    server = _server(pkg, internal_port=0)
    try:
        pub, adm = server.listen_port, server.internal_port
        assert adm > 0 and adm != pub
        ch = _channel(pkg, f"127.0.0.1:{adm}", timeout_ms=3000, max_retry=0)
        cntl, _ = _call(pkg, ch, "leak?")
        refused = (cntl.failed(), cntl.error_code)
        # the service port still serves
        ch2 = _channel(pkg, f"127.0.0.1:{pub}", timeout_ms=3000)
        cntl2, resp = _call(pkg, ch2, "ok")
        served = not cntl2.failed() and resp.message == "ok"
        ch.close()
        ch2.close()
        return refused, served
    finally:
        server.stop()


def test_internal_port_refusal_code_equals_jax():
    jax_res = _internal_refusal(JAX)
    port_res = _internal_refusal(PORT)
    assert port_res == jax_res
    assert port_res[0][0] and port_res[1]


def test_internal_port_with_ici_listener_stays_loopback():
    mesh = TMesh(ranks=8, device="cpu")
    TMesh.set_default(mesh)
    server = trpc.Server(trpc.ServerOptions(internal_port=0,
                                            native_ici=False))
    assert server.start("ici://6") == 0
    try:
        adm = server.internal_port
        assert adm > 0
        acc = server._internal_acceptor
        assert acc.listen_sock.getsockname()[0] == "127.0.0.1"
    finally:
        server.stop()
    assert server.internal_port == -1


def test_connect_timeout_ms_reaches_tcp_connect(monkeypatch):
    server = _server(PORT)
    seen = {}
    real = ttcp.tcp_connect

    def spy(ep, timeout=5.0):
        seen["timeout"] = timeout
        return real(ep, timeout=timeout)

    monkeypatch.setattr(ttcp, "tcp_connect", spy)
    try:
        ch = _channel(PORT, f"127.0.0.1:{server.listen_port}",
                      timeout_ms=5000, connect_timeout_ms=1234)
        cntl, resp = _call(PORT, ch, "x")
        assert not cntl.failed(), cntl.error_text
        assert abs(seen["timeout"] - 1.234) < 1e-9
        ch.close()
    finally:
        server.stop()


def test_connect_refused_fails_the_call():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ch = _channel(PORT, f"127.0.0.1:{port}", timeout_ms=2000, max_retry=0,
                  connect_timeout_ms=500)
    cntl, _ = _call(PORT, ch, "x")
    assert cntl.failed()
    ch.close()


def _streamed(pkg, nchunks=64, chunk=64 << 10):
    received = []
    closed = threading.Event()

    class Handler:
        def on_received_messages(self, sid, msgs):
            for m in msgs:
                received.append(m.to_bytes())

        def on_closed(self, sid):
            closed.set()

    class StreamSvc(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Start(self, cntl, request, response, done):
            pkg.rpc.stream_accept(cntl, pkg.rpc.StreamOptions(
                handler=Handler(), max_buf_size=1 << 20))
            response.message = "ok"
            done()

    server = pkg.rpc.Server()
    server.add_service(StreamSvc())
    assert server.start("tcp://127.0.0.1:0") == 0
    try:
        ch = _channel(pkg, f"tcp://127.0.0.1:{server.listen_port}")
        cntl = pkg.rpc.Controller()
        st = pkg.rpc.stream_create(cntl, pkg.rpc.StreamOptions(
            max_buf_size=1 << 20))
        ch.call_method("StreamSvc.Start", cntl, pkg.Req(message="s"),
                       pkg.Resp)
        assert not cntl.failed(), cntl.error_text
        assert st.wait_connected(5)
        for i in range(nchunks):
            assert st.write(pkg.Buf(bytes([i % 251]) * chunk),
                            timeout=10) == 0
        deadline = time.monotonic() + 20
        while sum(map(len, received)) < nchunks * chunk \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        st.close()
        closed.wait(5)
        ch.close()
        return b"".join(received)
    finally:
        server.stop()


def test_stream_over_tcp_delivers_what_jax_delivers():
    """bench.py's bench_streaming_mbps tcp leg at a small size: the
    sliding window over a real socket, the same bytes on both."""
    got = _streamed(PORT)
    assert got == _streamed(JAX)
    assert len(got) == 64 * (64 << 10)


def test_iobuf_fd_io_equals_jax():
    """cut_into_file_descriptor and append_from_socket move the same
    bytes as the JAX package's over a socket pair."""
    payload = [b"head", bytes(range(256)) * 40, b"tail" * 3000]
    for pkg in (JAX, PORT):
        a, b = socket.socketpair()
        try:
            buf = pkg.Buf()
            for p in payload:
                buf.append(p)
            total = len(buf)
            sent = 0
            while len(buf):
                sent += buf.cut_into_file_descriptor(a.fileno())
            assert sent == total
            b.setblocking(False)
            portal = pkg.Portal()
            got = 0
            while got < total:
                n = portal.append_from_socket(b, 1 << 16)
                if n > 0:
                    got += n
            assert portal.to_bytes() == b"".join(payload)
            a.close()
            assert portal.append_from_socket(b, 1024) == 0   # EOF
        finally:
            a.close()
            b.close()
    b1, b2 = socket.socketpair()
    try:
        b2.setblocking(False)
        assert TPortal().append_from_socket(b2, 16) == -1    # EAGAIN
    finally:
        b1.close()
        b2.close()


_TCP_SERVER = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

class EchoService(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "srv:" + request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()

server = rpc.Server()
server.add_service(EchoService())
assert server.start("127.0.0.1:0") == 0
print(json.dumps({"port": server.listen_port}), flush=True)
sys.stdin.read()             # serve until the test closes our stdin
server.stop()
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "jaxlib", "brpc_tpu.")) or m == "brpc_tpu")
print(json.dumps({"jax_or_brpc_tpu": mods}), flush=True)
"""


def test_cross_process_tcp_echo():
    """test_multiprocess.py's shape on the port: a server in a fresh
    interpreter, calls from here, byte-exact attachments; the child loads
    no JAX and nothing of the JAX package."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _TCP_SERVER % {"repo": _REPO}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        port = json.loads(proc.stdout.readline())["port"]
        ch = _channel(PORT, f"127.0.0.1:{port}", timeout_ms=10000)
        for i in range(50):
            att = bytes([i]) * (1000 + 997 * i)
            cntl, resp = _call(PORT, ch, str(i), att=att)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == f"srv:{i}"
            assert cntl.response_attachment.to_bytes() == att
        ch.close()
        proc.stdin.close()
        tail = json.loads(proc.stdout.readline())
        assert proc.wait(20) == 0
        assert tail["jax_or_brpc_tpu"] == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_client_survives_tcp_server_death():
    """tests/test_multiprocess.py's second case on the port: the server's
    process is killed; the next call fails cleanly instead of hanging."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _TCP_SERVER % {"repo": _REPO}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        port = json.loads(proc.stdout.readline())["port"]
        ch = _channel(PORT, f"127.0.0.1:{port}", timeout_ms=3000,
                      max_retry=0)
        cntl, resp = _call(PORT, ch, "a")
        assert not cntl.failed() and resp.message == "srv:a"
        proc.kill()
        proc.wait(10)
        time.sleep(0.2)
        t0 = time.monotonic()
        cntl, _ = _call(PORT, ch, "b")
        assert cntl.failed()
        assert time.monotonic() - t0 < 3.5
        ch.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
