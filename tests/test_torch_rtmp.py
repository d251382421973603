"""RTMP, AMF0, FLV and TS on both packages.

Every test of ``tests/test_rtmp.py`` runs over ``brpc_tpu`` and over
``brpc_tpu_torch`` (``tests/torch_mirror.py``, no swap; the digest fixture
``tests/fixtures/rtmp_digest_c1.bin`` is read, never written).  The JAX
file's module fixture ``rtmp_server`` is set on each package's
``TestRtmpEndToEnd`` class, built from that package's copy.  Then:

- seeded bytes equal between the packages: the simple and digest C0C1 a
  client sends, the S0S1S2 a server answers to each, chunked messages at
  chunk sizes 128 and 4096 with and without extended timestamps, AMF0
  commands, FLV tags and TS packets.  The handshake's random bytes and
  clock come from a seeded stand-in for each module's ``os`` and ``time``;
- one port serving rtmp beside tpu_std, redis and nshead, each protocol's
  client answered (rtmp claims no connection that is not its own);
- a second ``RtmpService`` on one server answers EINVAL;
- a stream's upcalls keep the sender's order (the ExecutionQueue);
- a dead connection ends a client stream's pending wait at once.
"""
from __future__ import annotations

import importlib
import sys
import threading
import time
import types

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_rtmp.py", globals())


def _rtmp_server_fixture(mod):
    """The JAX file's module fixture ``rtmp_server`` for one package's copy
    (a mirrored class looks its fixtures up on itself)."""
    @pytest.fixture()
    def rtmp_server(self):
        hub = mod._Hub()
        server = mod.rpc.Server()
        assert server.add_service(hub) == 0
        assert server.start("127.0.0.1:0") == 0
        yield server, hub
        server.stop()
    return rtmp_server


TestRtmpEndToEndJax.rtmp_server = _rtmp_server_fixture(  # noqa: F821
    sys.modules["tests._mirror_jax_test_rtmp"])
TestRtmpEndToEndPort.rtmp_server = _rtmp_server_fixture(  # noqa: F821
    sys.modules["tests._mirror_port_test_rtmp"])

ROOTS = {"jax": "brpc_tpu", "port": "brpc_tpu_torch"}


def _mods(root):
    return types.SimpleNamespace(**{
        n: importlib.import_module(f"{root}.policy.{n}")
        for n in ("amf", "flv", "ts", "rtmp")},
        rpc=importlib.import_module(f"{root}.rpc"),
        flags=importlib.import_module(f"{root}.butil.flags"),
        IOBuf=importlib.import_module(f"{root}.butil.iobuf").IOBuf)


class _Sink:
    """The Socket surface RtmpConnection writes to."""

    def __init__(self):
        self.sent = []
        self.failed = False
        self.on_failed_callbacks = []
        self.remote_side = None

    def write(self, data, **kw):
        self.sent.append(data.to_bytes())
        return 0


def _seeded(monkeypatch, rtmp, seed):
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(rtmp, "os", types.SimpleNamespace(
        urandom=lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
    monkeypatch.setattr(rtmp, "time", types.SimpleNamespace(
        monotonic=lambda: 4242.5, time=time.time))


def _handshake_bytes(monkeypatch, root, digest):
    m = _mods(root)
    _seeded(monkeypatch, m.rtmp, 7)
    old = m.flags.get_flag("rtmp_client_digest")
    m.flags.set_flag("rtmp_client_digest", digest)
    try:
        client = m.rtmp.RtmpConnection(_Sink(), is_server=False)
        client._start_client_handshake()
        c0c1 = client.socket.sent[0]
        server = m.rtmp.RtmpConnection(_Sink(), is_server=True)
        assert server.consume(m.IOBuf(c0c1))
        return c0c1, server.socket.sent
    finally:
        m.flags.set_flag("rtmp_client_digest", old)


@pytest.mark.parametrize("digest", [False, True])
def test_handshake_bytes_equal(monkeypatch, digest):
    j = _handshake_bytes(monkeypatch, "brpc_tpu", digest)
    t = _handshake_bytes(monkeypatch, "brpc_tpu_torch", digest)
    assert j == t
    assert len(t[0]) == 1 + 1536 and len(b"".join(t[1])) == 1 + 2 * 1536


def _chunked(root, chunk, stamps, bodies):
    m = _mods(root)
    conn = m.rtmp.RtmpConnection(_Sink(), is_server=True)
    conn.state = 3
    if chunk != 128:
        conn.set_out_chunk_size(chunk)
    for i, (ts, body) in enumerate(zip(stamps, bodies)):
        conn.send_message(4 + i % 3, 1, (8, 9, 18)[i % 3], ts, body)
    conn.send_message(330, 1, 9, 5, bodies[0])    # a 3-byte basic header
    conn._send_status(1, "status", "NetStream.Publish.Start", "go")
    return b"".join(conn.socket.sent)


@pytest.mark.parametrize("chunk", [128, 4096])
@pytest.mark.parametrize("extended", [False, True])
def test_chunked_messages_bytes_equal(chunk, extended):
    rng = np.random.default_rng(chunk + extended)
    sizes = [0, 1, 127, 128, 129, 4095, 4096, 4097, 20 << 10, 150 << 10]
    bodies = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in sizes]
    base = 0xFFFFFF if extended else 0
    stamps = [base + 33 * i for i in range(len(sizes))]
    j = _chunked("brpc_tpu", chunk, stamps, bodies)
    assert j == _chunked("brpc_tpu_torch", chunk, stamps, bodies)
    # the stream decodes back on the other package's connection
    t = _mods("brpc_tpu_torch")
    got = []
    rx = t.rtmp.RtmpConnection(_Sink(), is_server=True)
    rx.state = 3
    rx._dispatch = got.append
    if chunk != 128:
        rx.in_chunk_size = chunk
        j = j[16:]                     # the set-chunk-size control message
    assert rx.consume(t.IOBuf(j))
    assert [g.body for g in got[:len(sizes)]] == bodies
    assert [g.timestamp for g in got[:len(sizes)]] == stamps


def test_amf_flv_ts_bytes_equal():
    rng = np.random.default_rng(21)
    out = {}
    for name, root in ROOTS.items():
        m = _mods(root)
        meta = {"width": 1920.0, "height": 1080.0, "framerate": 30.0,
                "videocodecid": 7.0, "audiocodecid": 10.0,
                "stereo": True, "encoder": "seeded", "nothing": None}
        cmd = m.amf.encode("connect", 1.0, {"app": "live", "x": [1.0, "y"]},
                           m.amf.EcmaArray({"k": "v"}), m.amf.UNDEFINED)
        frames = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in (384, 20 << 10, 150 << 10)]
        rng = np.random.default_rng(21)   # the same frames for both
        w = m.flv.FlvWriter()
        w.write_meta_data(meta)
        w.write_audio(0, frames[0])
        w.write_video(33, frames[1])
        w.write_video(0x1234567, frames[2])
        mux = m.ts.TsMuxer()
        for i, f in enumerate(frames):
            mux.write_video(90000 + 3000 * i, b"\x00\x00\x00\x01\x65" + f)
            mux.write_audio(90000 + 1920 * i, b"\xff\xf1" + f[:300])
        out[name] = (cmd, w.buf.to_bytes(), mux.buf.to_bytes(),
                     m.amf.decode(cmd))
    assert out["jax"][:3] == out["port"][:3]
    assert len(out["port"][2]) % 188 == 0


def test_rtmp_beside_tpu_std_redis_and_nshead_on_one_port():
    from brpc_tpu_torch.tools import multi_protocol as mp
    t = _mods("brpc_tpu_torch")
    m = mp.port_modules()

    class Hub(t.rtmp.RtmpService):
        def __init__(self):
            self.published = []

        def new_stream(self, remote_side, connect_info):
            hub = self

            class S(t.rtmp.RtmpServerStream):
                def on_video_message(self, timestamp, data):
                    hub.published.append((timestamp, data))
            return S()

    hub = Hub()
    server = m.rpc.Server()
    for svc in mp.make_services(m) + [hub]:
        assert server.add_service(svc) == 0
    assert server.start("127.0.0.1:0") == 0
    clients = mp.Clients(m, server.listen_port)
    client = None
    try:
        for proto in ("tpu_std", "nshead", "hulu_pbrpc"):
            assert clients.echo(proto, "x" * 100) == "x" * 100
        assert clients.kv("redis", [("set", "k", b"v"),
                                    ("get", "k", b"")]) == [True, b"v"]
        client = t.rtmp.RtmpClient(f"127.0.0.1:{server.listen_port}")
        stream = client.create_stream()
        assert stream.publish("cam") == 0
        stream.send_video_message(b"\x17frame", timestamp=40)
        deadline = time.monotonic() + 5
        while not hub.published and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.published == [(40, b"\x17frame")]
        # the other protocols still answer after rtmp took its connection
        assert clients.echo("tpu_std", "y") == "y"
    finally:
        if client is not None:
            client.stop()
        clients.close()
        server.stop()


@pytest.mark.parametrize("root", list(ROOTS.values()))
def test_second_rtmp_service_is_einval(root):
    m = _mods(root)
    server = m.rpc.Server()
    assert server.add_service(m.rtmp.RtmpService()) == 0
    assert server.add_service(m.rtmp.RtmpService()) == m.rpc.errors.EINVAL


def _relay_server(m, on_publish=None):
    class Hub(m.rtmp.RtmpService):
        def __init__(self):
            self.got = []

        def new_stream(self, remote_side, connect_info):
            hub = self

            class S(m.rtmp.RtmpServerStream):
                def on_publish(self, name, publish_type="live"):
                    return on_publish() if on_publish else 0

                def on_audio_message(self, timestamp, data):
                    hub.got.append(data)

                def on_video_message(self, timestamp, data):
                    hub.got.append(data)
            return S()

    hub = Hub()
    server = m.rpc.Server()
    assert server.add_service(hub) == 0
    assert server.start("127.0.0.1:0") == 0
    return server, hub


@pytest.mark.parametrize("root", list(ROOTS.values()))
def test_stream_upcalls_keep_order(root):
    m = _mods(root)
    server, hub = _relay_server(m)
    client = m.rtmp.RtmpClient(f"127.0.0.1:{server.listen_port}")
    try:
        stream = client.create_stream()
        assert stream.publish("seq") == 0
        client._conn.set_out_chunk_size(4096)
        sent = []
        for i in range(300):
            body = i.to_bytes(4, "big") + bytes(i % 7 * 1000)
            sent.append(body)
            if i % 3:
                stream.send_video_message(body, timestamp=i)
            else:
                stream.send_audio_message(body, timestamp=i)
        deadline = time.monotonic() + 10
        while len(hub.got) < len(sent) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.got == sent
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("root", list(ROOTS.values()))
def test_dead_connection_ends_a_pending_publish(root):
    m = _mods(root)
    release = threading.Event()

    def slow_accept():
        release.wait(10)
        return 0

    server, _hub = _relay_server(m, slow_accept)
    client = m.rtmp.RtmpClient(f"127.0.0.1:{server.listen_port}")
    try:
        stream = client.create_stream()
        out = []
        th = threading.Thread(target=lambda: out.append(
            stream.publish("held", timeout=10)))
        th.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        client._socket.set_failed(m.rpc.errors.EFAILEDSOCKET, "test kill")
        th.join(5)
        assert not th.is_alive() and out and out[0] != 0
        assert time.monotonic() - t0 < 2.0
    finally:
        release.set()
        client.stop()
        server.stop()
