"""The port's streaming RPC, held against the JAX package on the CPU.

Mirrors ``tests/test_stream.py`` (``TestStreaming`` and the ici case of
``TestStreamingRealTransports``) and ``tests/test_progressive.py``: each
scenario runs on the JAX package's stack over ``mem://`` and on the
port's over ``mem://`` and over ``ici://`` on a CPU mesh with the device
plane engaged, and every run must see the same outcome.  Besides:

  * the stream frames (the handshake request, DATA, FEEDBACK, CLOSE, RST)
    pack to identical bytes in both packages;
  * a DEVICE chunk crosses an ``ici://`` stream on the plane: it lands
    byte-equal on the server's rank, one plane transfer a chunk, and the
    received tensor is freed once the handler lets it go;
  * the ExecutionQueue delivers in order, stops after its queued tasks,
    and holds no delivered task after its handler returned;
  * a server's lame-duck stop waits for an open stream and, past the
    grace window, closes it with an orderly CLOSE after every byte the
    client wrote.
"""
from __future__ import annotations

import gc
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.bthread.execution_queue import ExecutionQueue as JExecQueue
from brpc_tpu.rpc import errors as jerrors
from brpc_tpu.rpc import stream as jstream
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.bthread.execution_queue import ExecutionQueue
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.iobuf import DEVICE, IOBuf
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors, health_check, lameduck
from brpc_tpu_torch.rpc import stream as tstream
from brpc_tpu_torch.rpc.circuit_breaker import BreakerRegistry
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import EchoRequest as JEchoRequest
from tests.echo_pb2 import EchoResponse as JEchoResponse
from tests.torch_census import custody_census  # noqa: F401  (fixture)

WAIT_S = 10.0
_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, IOBuf=JIOBuf,
                            errors=jerrors, Req=JEchoRequest,
                            Resp=JEchoResponse)
PORT = types.SimpleNamespace(name="torch", rpc=rpc, IOBuf=IOBuf,
                             errors=errors, Req=EchoRequest,
                             Resp=EchoResponse)


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server, channel and stream here is closed by its test; at
    teardown the port's sockets, streams, pooled server Controllers and
    plane pins are all returned."""
    yield
    deadline = time.monotonic() + 2.0
    plane = dp.DevicePlane._instance
    while (rpc.list_sockets() or rpc.live_streams()
           or server_controller_pool.live()
           or (plane is not None and plane.active_transfers())) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert not rpc.live_streams()
    assert server_controller_pool.live() == 0
    assert plane is None or plane.active_transfers() == 0


@pytest.fixture(autouse=True)
def leaves_no_endpoint_state():
    """A test that stops a server or trips a breaker leaves process-wide
    state behind: a peer's drain mark, a health check probing it, an
    isolated breaker.  Each is undone here, so a later test on the same
    endpoint (another module's, in the same worker) starts clean."""
    yield
    for ep in list(health_check._tasks):
        health_check._tasks[ep].cancel()
    for ep in lameduck.peer_draining():
        lameduck.clear_peer_draining(ep)
    reg = BreakerRegistry.instance()
    with reg._lock:
        breakers = list(reg._map.values())
    for b in breakers:
        if b.is_isolated():
            b.mark_recovered()


@pytest.fixture
def mesh():
    """A CPU mesh whose attachments at or above 4 KiB ride the device
    plane (the plain p2p_copy)."""
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    m = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(m)
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 4096)
    yield m
    for n, v in saved.items():
        tflags.set_flag(n, v)
    IciMesh.set_default(None)


_seq = iter(range(100_000))


def _until(pred, timeout: float = WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.002)
    return True


# ---- the scenarios of tests/test_stream.py, on either stack -------------

def _collector(pkg):
    class Collector(pkg.rpc.StreamInputHandler):
        def __init__(self):
            self.messages = []
            self.closed = threading.Event()
            self.lock = threading.Lock()

        def on_received_messages(self, sid, msgs):
            with self.lock:
                self.messages.extend(m.to_bytes() for m in msgs)

        def on_closed(self, sid):
            self.closed.set()

    return Collector()


def _echo_stream_service(pkg):
    class StreamingEchoService(pkg.rpc.Service):
        """Accepts a stream and echoes every chunk back on it."""

        def __init__(self):
            self.server_streams = []

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def StartStream(self, cntl, request, response, done):
            class EchoBack(pkg.rpc.StreamInputHandler):
                def __init__(self):
                    self.stream = None

                def on_received_messages(self, sid, msgs):
                    for m in msgs:
                        self.stream.write(pkg.IOBuf(b"echo:" + m.to_bytes()),
                                          timeout=WAIT_S)

            h = EchoBack()
            stream = pkg.rpc.stream_accept(
                cntl, pkg.rpc.StreamOptions(handler=h))
            h.stream = stream
            self.server_streams.append(stream)
            response.message = "accepted"
            done()

    return StreamingEchoService()


class _Rig:
    """A streaming echo server and one stream to it, on ``pkg``'s stack
    over ``transport``."""

    def __init__(self, pkg, transport, max_buf_size=None):
        self.pkg = pkg
        self.server = pkg.rpc.Server()
        self.svc = _echo_stream_service(pkg)
        self.server.add_service(self.svc)
        n = next(_seq)
        target = (f"mem://tstrm-{pkg.name}-{n}" if transport == "mem"
                  else f"ici://{1 + n % 7}")
        assert self.server.start(target) == 0
        self.ch = pkg.rpc.Channel()
        self.ch.init(target, options=pkg.rpc.ChannelOptions(
            timeout_ms=int(WAIT_S * 1000)))
        self.collector = _collector(pkg)
        self.cntl = pkg.rpc.Controller()
        opts = pkg.rpc.StreamOptions(handler=self.collector)
        if max_buf_size is not None:
            opts.max_buf_size = max_buf_size
        self.stream = pkg.rpc.stream_create(self.cntl, opts)
        self.resp = self.ch.call_method(
            "StreamingEchoService.StartStream", self.cntl,
            pkg.Req(message="s"), pkg.Resp)

    def close(self):
        self.stream.close()
        self.ch.close()
        self.server.stop()


def _stacks():
    """(package, transport) pairs every scenario runs on."""
    return [pytest.param((JAX, "mem"), id="jax-mem"),
            pytest.param((PORT, "mem"), id="torch-mem"),
            pytest.param((PORT, "ici"), id="torch-ici")]


@pytest.fixture(params=_stacks())
def stack(request):
    pkg, transport = request.param
    if transport == "ici":
        request.getfixturevalue("mesh")
    return pkg, transport


def test_handshake_and_bidirectional_data(stack):
    rig = _Rig(*stack)
    try:
        assert not rig.cntl.failed(), rig.cntl.error_text
        assert rig.resp.message == "accepted"
        assert rig.stream.wait_connected(5)
        for i in range(5):
            assert rig.stream.write(rig.pkg.IOBuf(b"chunk%d" % i)) == 0
        assert _until(lambda: len(rig.collector.messages) >= 5)
        assert rig.collector.messages == [b"echo:chunk%d" % i
                                          for i in range(5)]
    finally:
        rig.close()


def test_window_blocks_and_feedback_unblocks(stack):
    rig = _Rig(*stack, max_buf_size=100)
    try:
        assert rig.stream.wait_connected(5)
        EAGAIN = rig.pkg.errors.EAGAIN
        assert rig.stream.append_if_not_full(rig.pkg.IOBuf(b"x" * 80)) == 0
        assert rig.stream.append_if_not_full(
            rig.pkg.IOBuf(b"y" * 80)) == EAGAIN
        rig.stream.set_remote_consumed(80)
        assert rig.stream.append_if_not_full(rig.pkg.IOBuf(b"y" * 80)) == 0
    finally:
        rig.close()


def test_blocking_write_waits_for_credits(stack):
    rig = _Rig(*stack, max_buf_size=64)
    try:
        assert rig.stream.wait_connected(5)
        assert rig.stream.write(rig.pkg.IOBuf(b"a" * 60)) == 0
        done = []
        w = threading.Thread(target=lambda: done.append(
            rig.stream.write(rig.pkg.IOBuf(b"b" * 60), timeout=WAIT_S)))
        w.start()
        time.sleep(0.05)
        assert not done                  # still blocked on the window
        rig.stream.set_remote_consumed(60)
        w.join(WAIT_S)
        assert done == [0]
    finally:
        rig.close()


def test_close_propagates_to_peer(stack):
    rig = _Rig(*stack)
    try:
        assert rig.stream.wait_connected(5)
        srv_stream = rig.svc.server_streams[-1]
        rig.stream.close()
        assert _until(lambda: srv_stream.closed)
    finally:
        rig.close()


def test_write_after_close_fails(stack):
    rig = _Rig(*stack)
    try:
        assert rig.stream.wait_connected(5)
        rig.stream.close()
        assert rig.stream.append_if_not_full(
            rig.pkg.IOBuf(b"z")) == rig.pkg.errors.EINVAL
    finally:
        rig.close()


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])
def test_streaming_roundtrip_crosses_the_window(pkg, mesh):
    """``TestStreamingRealTransports.test_streaming_over_ici``: 40 writes
    of 8 KiB, more than the default window, echoed in order."""
    rig = _Rig(pkg, "ici")
    try:
        assert not rig.cntl.failed(), rig.cntl.error_text
        assert rig.stream.wait_connected(5)
        payload = b"z" * 8192
        for i in range(40):
            assert rig.stream.write(pkg.IOBuf(b"%03d:" % i + payload),
                                    timeout=WAIT_S) == 0
        assert _until(lambda: len(rig.collector.messages) >= 40)
        assert rig.collector.messages == [b"echo:%03d:" % i + payload
                                          for i in range(40)]
    finally:
        rig.close()


# ---- tests/test_progressive.py, on either stack -------------------------

def _download_service(pkg, nparts, part):
    class DownloadService(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Download(self, cntl, request, response, done):
            pa = pkg.rpc.create_progressive_attachment(cntl)
            response.message = "header"
            done()                       # the response header goes first

            def feed():
                for i in range(nparts):
                    assert pa.append(b"%d:" % i + part) == 0
                pa.close()

            threading.Thread(target=feed, daemon=True).start()

    return DownloadService()


@pytest.mark.parametrize("nparts,part", [(5, b"x" * 1000),
                                         (40, b"y" * 4096)],
                         ids=["parts-after-response", "flow-control"])
def test_progressive_parts(stack, nparts, part):
    pkg, transport = stack
    server = pkg.rpc.Server()
    server.add_service(_download_service(pkg, nparts, part))
    n = next(_seq)
    target = (f"mem://tdl-{pkg.name}-{n}" if transport == "mem"
              else f"ici://{1 + n % 7}")
    assert server.start(target) == 0
    ch = pkg.rpc.Channel()
    try:
        ch.init(target)
        got = []
        reader = pkg.rpc.ProgressiveReader(on_part=lambda d: got.append(d))
        cntl = pkg.rpc.Controller()
        pkg.rpc.response_will_be_read_progressively(cntl, reader)
        resp = ch.call_method("DownloadService.Download", cntl,
                              pkg.Req(message="get"), pkg.Resp)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "header"
        assert reader.wait(WAIT_S)
        assert reader.error_code == 0
        assert reader.data() == b"".join(b"%d:" % i + part
                                         for i in range(nparts))
        assert len(got) == nparts
    finally:
        cntl.stream_creator.close()
        ch.close()
        server.stop()


# ---- frames: identical bytes in both packages ---------------------------

class _CaptureSock:
    def __init__(self):
        self.frames = []
        self.failed = False
        self.on_failed_callbacks = []

    def write(self, buf, notify_cid=0):
        self.frames.append(buf.to_bytes())
        return 0


def _stream_frames(mod, iobuf):
    s = mod.Stream(mod.StreamOptions(max_buf_size=1 << 20), is_client=True)
    s.sid, s.remote_sid = 0x500000003, 0x700000009
    s.socket = sock = _CaptureSock()
    s.connected = True
    s._send_frame(mod.FRAME_DATA, iobuf(b"chunk-0" * 100))
    s._send_frame(mod.FRAME_DATA, iobuf(b""))
    s._local_consumed = 123457
    s.send_feedback()
    s._send_frame(mod.FRAME_RST, None)
    s._send_frame(mod.FRAME_CLOSE, None)
    return sock.frames


def test_stream_frames_pack_identically():
    assert (tstream.FRAME_DATA, tstream.FRAME_FEEDBACK, tstream.FRAME_RST,
            tstream.FRAME_CLOSE, tstream.FRAME_DATA_BULK,
            tstream.FRAME_DATA_SHM, tstream.FRAME_DATA_SHM_BATCH) == (
        jstream.FRAME_DATA, jstream.FRAME_FEEDBACK, jstream.FRAME_RST,
        jstream.FRAME_CLOSE, jstream.FRAME_DATA_BULK, jstream.FRAME_DATA_SHM,
        jstream.FRAME_DATA_SHM_BATCH)
    port = _stream_frames(tstream, IOBuf)
    ref = _stream_frames(jstream, JIOBuf)
    assert len(port) == 5
    assert port == ref


def test_handshake_request_packs_identically():
    from brpc_tpu.policy import tpu_std as jstd
    from brpc_tpu_torch.policy import tpu_std as tstd

    def frame(std, pkg, mod):
        cntl = pkg.rpc.Controller()
        cntl.log_id = 77
        s = mod.Stream(mod.StreamOptions(), is_client=True)
        s.sid = 0x300000011
        cntl.stream_creator = s
        payload = std.serialize_request(pkg.Req(message="hs"), cntl)
        return std.pack_request(payload, 0x1200000005, cntl,
                                "StreamingEchoService.StartStream").to_bytes()

    assert frame(tstd, PORT, tstream) == frame(jstd, JAX, jstream)


# ---- DEVICE frames on the CPU mesh ---------------------------------------

class _Keep(rpc.StreamInputHandler):
    def __init__(self, keep: bool):
        self.keep = keep
        self.got = []
        self.refs = []
        self.closed = threading.Event()

    def on_received_messages(self, sid, msgs):
        for m in msgs:
            r = m.backing_block(0)
            self.got.append((m.backing_block_num(), r.block.kind,
                             m.to_bytes()))
            self.refs.append(weakref.ref(r.block.data))
            if self.keep:
                self.refs.append(r.block.data)

    def on_closed(self, sid):
        self.closed.set()


def _device_stream(mesh, handler, server_rank=3, max_buf_size=1 << 20):
    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Open(self, cntl, request, response, done):
            rpc.stream_accept(cntl, rpc.StreamOptions(
                handler=handler, max_buf_size=max_buf_size))
            done()

    server = rpc.Server()
    server.add_service(Sink())
    assert server.start(f"ici://{server_rank}") == 0
    ch = rpc.Channel()
    ch.init(f"ici://{server_rank}",
            options=rpc.ChannelOptions(timeout_ms=int(WAIT_S * 1000)))
    cntl = rpc.Controller()
    st = rpc.stream_create(cntl, rpc.StreamOptions(
        max_buf_size=max_buf_size))
    ch.call_method("Sink.Open", cntl, EchoRequest(message="o"),
                   EchoResponse)
    assert not cntl.failed(), cntl.error_text
    assert st.wait_connected(5)
    return server, ch, st


def test_device_chunks_cross_on_the_plane(mesh):
    """8 DEVICE chunks of 64 KiB owned by the client's rank: each lands
    on the server's rank byte-equal, one plane transfer a chunk, and one
    view of its tensor though the server's reads are cut at 10,000 B."""
    h = _Keep(keep=False)
    server, ch, st = _device_stream(mesh, h)
    try:
        for sock in server.connections():
            sock.read_chunk_hint = 10_000
        plane = dp.plane()
        t0 = plane.stats()["transfers"]
        rng = np.random.default_rng(6)
        sent = []
        for _ in range(8):
            a = rng.integers(0, 256, 65536, dtype=np.uint8)
            sent.append(a.tobytes())
            buf = IOBuf()
            buf.append_device_array(mesh.own(torch.from_numpy(a), 4))
            assert st.write(buf, timeout=WAIT_S) == 0
        st.close()
        assert h.closed.wait(WAIT_S)
        assert [g[2] for g in h.got] == sent
        assert all(g[0] == 1 and g[1] == DEVICE for g in h.got)
        assert plane.stats()["transfers"] - t0 == 8
    finally:
        ch.close()
        server.stop()


def test_a_read_never_ends_inside_a_device_block():
    from brpc_tpu_torch.ici import transport
    buf = IOBuf()
    buf.append(b"h" * 100)
    buf.append_device_array(torch.zeros(1000, dtype=torch.uint8))
    buf.append(b"t" * 50)
    cuts = [transport._device_block_end(buf, n)
            for n in (50, 100, 101, 1099, 1100, 1120, 5000)]
    assert cuts == [50, 100, 1100, 1100, 1100, 1120, 5000]


def test_a_consumed_device_chunk_is_freed(mesh):
    """A handler that drops its chunk leaves nothing holding the received
    tensor: not the delivery queue, its worker, the socket or the plane's
    poller.  One that keeps it keeps it alive."""
    for keep in (False, True):
        h = _Keep(keep=keep)
        server, ch, st = _device_stream(mesh, h)
        try:
            buf = IOBuf()
            buf.append_device_array(mesh.own(
                torch.full((65536,), 7, dtype=torch.uint8), 4))
            assert st.write(buf, timeout=WAIT_S) == 0
            del buf
            assert _until(lambda: len(h.got) == 1)
            gc.collect()
            assert _until(lambda: (h.refs[0]() is None) != keep, 2.0), \
                f"keep={keep}: the received tensor's liveness is wrong"
        finally:
            st.close()
            ch.close()
            server.stop()


# ---- ExecutionQueue ------------------------------------------------------

@pytest.mark.parametrize("cls", [JExecQueue, ExecutionQueue],
                         ids=["jax", "torch"])
def test_execution_queue_orders_batches_and_stops(cls):
    seen, batches = [], []

    def handler(it):
        batch = list(it)
        batches.append(len(batch))
        seen.extend(batch)
        time.sleep(0.001)

    q = cls(handler)
    for i in range(200):
        assert q.execute(i) == 0
    assert q.stop() == 0
    assert q.execute(999) != 0           # stopped: refused
    assert q.join(WAIT_S)
    assert seen == list(range(200))
    assert sum(batches) == 200


def test_execution_queue_holds_no_delivered_task():
    class Task:
        pass

    done = threading.Event()
    q = ExecutionQueue(lambda it: [done.set() for _ in it], linger_s=0.5)
    t = Task()
    ref = weakref.ref(t)
    q.execute(t)
    del t
    assert done.wait(WAIT_S)
    # the consumer is lingering for more work; the task is already gone
    assert _until(lambda: ref() is None, 0.4)
    q.stop()
    assert q.join(WAIT_S)


# ---- the lame-duck stop with a stream open ------------------------------

@pytest.mark.parametrize("client_closes", [False, True],
                         ids=["straggler", "closed-in-window"])
def test_server_stop_drains_then_closes_an_open_stream(mesh, client_closes):
    """``stop(grace)`` waits for the open stream.  Closed by the client
    inside the window, the drain converges; left open, the server closes
    it past the window with an orderly CLOSE, after every byte the client
    wrote, and the client sees the CLOSE, not a reset."""
    h = _Keep(keep=False)
    server, ch, st = _device_stream(mesh, h, server_rank=6)
    try:
        sent = []
        for i in range(6):
            a = np.full(8192, i, dtype=np.uint8)
            sent.append(a.tobytes())
            buf = IOBuf()
            buf.append_device_array(mesh.own(torch.from_numpy(a), 7))
            assert st.write(buf, timeout=WAIT_S) == 0
        stopper = threading.Thread(target=server.stop, args=(0.5,))
        stopper.start()
        assert _until(server.is_draining)
        if client_closes:
            time.sleep(0.05)
            st.close()
        stopper.join(WAIT_S)
        assert not stopper.is_alive()
        assert server.last_drain["drained"] is client_closes
        assert h.closed.wait(WAIT_S)
        assert [g[2] for g in h.got] == sent
        assert st.closed
        assert st.close_reason == ("local" if client_closes else "close")
        assert st.append_if_not_full(IOBuf(b"late")) == errors.EINVAL
    finally:
        st.close()
        ch.close()
        server.stop()


def test_a_streaming_call_takes_no_balancer_and_no_retry():
    cntl = rpc.Controller()
    st = rpc.stream_create(cntl)
    ch = rpc.Channel()
    ch.init("list://mem://nobody-a,mem://nobody-b")
    assert ch.call_method("S.M", cntl, EchoRequest(), EchoResponse) is None
    assert cntl.error_code == errors.EINVAL
    st.close()
    ch.close()
    cntl = rpc.Controller()
    st = rpc.stream_create(cntl)
    one = rpc.Channel()
    one.init("mem://nobody-c", options=rpc.ChannelOptions(max_retry=3))
    one.call_method("S.M", cntl, EchoRequest(), EchoResponse)
    assert cntl.failed() and cntl.retried_count == 0
    st.close()
    one.close()
