"""TLS on both packages: every test of ``tests/test_tls.py`` over
``brpc_tpu_torch`` (``tests/torch_mirror.py``'s port copy, no swap, as
``TestTlsPort``; the file runs on ``brpc_tpu`` as itself, and a second JAX
copy here would only repeat it and the race below), then checks the JAX
file does not make, each over both packages:

- a TLS connection relayed through a recording proxy carries no plaintext
  of a seeded 4 KiB random attachment, in either direction;
- a TLS channel and a plaintext channel to one TLS endpoint never share a
  connection (the connection key holds TLS): the plaintext one fails, in
  whichever order the two first call, and the TLS one keeps working;
- a 4 KiB echo with its attachment back, and a 1 MiB one, over TLS (the
  port only).

The JAX runs of these checks give the server context ``num_tickets = 0``:
the JAX package's TCP socket reads and writes one ``SSLSocket`` on two
threads at once (its reader tasklet and the caller), and TLS 1.3 session
tickets arriving during a first call let that race stall the call now and
then.  The port serializes the two under a lock and runs with the default
context.
"""
from __future__ import annotations

import importlib
import socket
import ssl
import subprocess
import threading

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from tests import torch_mirror
from tests.echo_pb2 import EchoRequest, EchoResponse
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

TestTlsPort = type("TestTlsPort", (torch_mirror.load(
    "tests/test_tls.py", port=True).TestTls,), {"__module__": __name__})


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    key, crt = str(d / "key.pem"), str(d / "cert.pem")
    subprocess.run([
        "openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
        "-out", crt, "-days", "1", "-nodes", "-subj", "/CN=localhost",
        "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
    ], check=True, capture_output=True)
    return key, crt


@pytest.fixture(params=["jax", "port"])
def rpc(request):
    name = "brpc_tpu.rpc" if request.param == "jax" else "brpc_tpu_torch.rpc"
    return importlib.import_module(name)


def _contexts(certs, rpc=None):
    key, crt = certs
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(crt, key)
    if rpc is not None and not rpc.__name__.startswith("brpc_tpu_torch"):
        server_ctx.num_tickets = 0      # see the module docstring

    client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client_ctx.load_verify_locations(crt)
    return server_ctx, client_ctx


def _echo_server(rpc, server_ctx):
    class EchoService(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(ssl_context=server_ctx))
    server.add_service(EchoService())
    assert server.start("127.0.0.1:0") == 0
    return server


class _RecordingRelay:
    """A plain TCP relay that keeps every byte it forwards."""

    def __init__(self, target_port: int):
        self.target = ("127.0.0.1", target_port)
        self.ls = socket.create_server(("127.0.0.1", 0))
        self.port = self.ls.getsockname()[1]
        self.up = bytearray()          # client -> server
        self.down = bytearray()        # server -> client
        self._threads = []
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        try:
            conn, _ = self.ls.accept()
        except OSError:
            return
        peer = socket.create_connection(self.target)
        for src, dst, rec in ((conn, peer, self.up),
                              (peer, conn, self.down)):
            t = threading.Thread(target=self._pump, args=(src, dst, rec),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _pump(src, dst, rec):
        try:
            while True:
                chunk = src.recv(65536)
                if not chunk:
                    break
                rec += chunk
                dst.sendall(chunk)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self):
        self.ls.close()
        for t in self._threads[1:]:
            t.join(5)


def _call(rpc, ch, message="x", attachment=b"", timeout_ms=5000):
    cntl = rpc.Controller()
    cntl.timeout_ms = timeout_ms
    if attachment:
        cntl.request_attachment.append(attachment)
    resp = ch.call_method("EchoService.Echo", cntl,
                          EchoRequest(message=message), EchoResponse)
    return cntl, resp


def test_tls_relay_carries_no_plaintext(rpc, certs):
    server_ctx, client_ctx = _contexts(certs, rpc)
    server = _echo_server(rpc, server_ctx)
    relay = _RecordingRelay(server.listen_port)
    payload = np.random.default_rng(2121).integers(
        0, 256, 4096, dtype=np.uint8).tobytes()
    ch = rpc.Channel()
    try:
        ch.init(f"127.0.0.1:{relay.port}",
                options=rpc.ChannelOptions(timeout_ms=5000,
                                           ssl_context=client_ctx))
        cntl, resp = _call(rpc, ch, "secret-message", payload)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "secret-message"
        assert cntl.response_attachment.to_bytes() == payload
    finally:
        ch.close()
        server.stop()
        relay.close()
    assert len(relay.up) > len(payload) and len(relay.down) > len(payload)
    for wire in (bytes(relay.up), bytes(relay.down)):
        # no 64-byte window of the payload crossed in the clear
        for off in range(0, len(payload) - 64, 64):
            assert payload[off:off + 64] not in wire
        assert b"secret-message" not in wire


@pytest.mark.parametrize("tls_first", [True, False])
def test_tls_and_plaintext_channels_never_share(rpc, certs, tls_first):
    server_ctx, client_ctx = _contexts(certs, rpc)
    server = _echo_server(rpc, server_ctx)
    target = f"127.0.0.1:{server.listen_port}"
    tls_ch, plain_ch = rpc.Channel(), rpc.Channel()
    tls_ch.init(target, options=rpc.ChannelOptions(
        timeout_ms=5000, ssl_context=client_ctx))
    plain_ch.init(target, options=rpc.ChannelOptions(timeout_ms=1000,
                                                     max_retry=0))
    try:
        order = [(tls_ch, True), (plain_ch, False)]
        if not tls_first:
            order.reverse()
        for ch, ok in order + order:
            cntl, resp = _call(rpc, ch, "m")
            assert cntl.failed() != ok, cntl.error_text
            if ok:
                assert resp.message == "m"
    finally:
        tls_ch.close()
        plain_ch.close()
        server.stop()


@pytest.mark.parametrize("size", [4096, 1 << 20])
def test_tls_attachment_echo(certs, size):
    import brpc_tpu_torch.rpc as rpc
    server_ctx, client_ctx = _contexts(certs, rpc)
    server = _echo_server(rpc, server_ctx)
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    ch = rpc.Channel()
    try:
        ch.init(f"127.0.0.1:{server.listen_port}",
                options=rpc.ChannelOptions(timeout_ms=20000,
                                           ssl_context=client_ctx))
        for _ in range(3):
            cntl, _resp = _call(rpc, ch, "a", payload, timeout_ms=20000)
            assert not cntl.failed(), cntl.error_text
            assert cntl.response_attachment.to_bytes() == payload
    finally:
        ch.close()
        server.stop()
