"""The slice as a whole: ici:// echo with device attachments, the port
against the JAX package.

An echo server on ``ici://0`` and a client on rank 1 in both packages
(the JAX server on its Python IciSocket plane, ``native_ici=False``; both
planes engaged on the CPU mesh with a 1 KiB threshold).  Attachments of
512 B (below the threshold: the ``device_put`` route), 4 KiB and 256 KiB
(the device plane) come from a numpy seed; responses, attachment bytes,
residency and plane transfers per call must agree.  Then the transport
properties of tests/test_ici.py on the port: window backpressure, exact
credit replenishment, source pins held until completion and ordered
delivery.
"""
import gc
import time

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import flags as jfl
from brpc_tpu.ici import device_plane as jdp
from brpc_tpu.ici.mesh import IciMesh as JaxMesh
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags as fl
from brpc_tpu_torch.butil.iobuf import IOBuf, IOPortal
from brpc_tpu_torch.convert import iobuf_from_segments
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici import transport as T
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import (EchoRequest as JEchoRequest,
                            EchoResponse as JEchoResponse)

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")


def _port_idle():
    return (not rpc.list_sockets() and server_controller_pool.live() == 0
            and dp.plane().active_transfers() == 0)


@pytest.fixture(scope="module", autouse=True)
def port_mesh():
    """CPU mesh of 8 ranks, both planes engaged with a 1 KiB threshold.
    At teardown the port's own pools must be empty (the root census
    counts only the JAX package's)."""
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    saved = {n: fl.get_flag(n) for n in _FLAGS}
    jsaved = {n: jfl.get_flag(n) for n in _FLAGS}
    for f in (fl, jfl):
        f.set_flag("ici_device_plane", True)
        f.set_flag("ici_device_plane_host_mesh", True)
        f.set_flag("ici_device_plane_threshold", 1024)
    yield mesh
    for n, v in saved.items():
        fl.set_flag(n, v)
    for n, v in jsaved.items():
        jfl.set_flag(n, v)
    IciMesh.set_default(None)
    deadline = time.monotonic() + 2.0
    while not _port_idle() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _port_idle(), (rpc.list_sockets(), server_controller_pool.live(),
                          dp.plane().active_transfers())


class PortEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        if len(cntl.request_attachment):
            cntl.response_attachment.append(cntl.request_attachment)
        done()


class JaxEcho(jrpc.Service):
    SERVICE_NAME = "EchoService"

    @jrpc.method(JEchoRequest, JEchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        if len(cntl.request_attachment):
            cntl.response_attachment.append(cntl.request_attachment)
        done()


@pytest.fixture()
def servers(port_mesh):
    psrv = rpc.Server(rpc.ServerOptions(usercode_inline=True))
    psrv.add_service(PortEcho())
    assert psrv.start("ici://0") == 0
    jsrv = jrpc.Server(jrpc.ServerOptions(native_ici=False,
                                          usercode_inline=True))
    jsrv.add_service(JaxEcho())
    assert jsrv.start("ici://0") == 0
    pch = rpc.Channel()
    pch.init("ici://0", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    jch = jrpc.Channel()
    jch.init("ici://0", options=jrpc.ChannelOptions(timeout_ms=30000,
                                                    max_retry=0))
    yield pch, jch
    pch.close()
    jch.close()
    psrv.stop()
    jsrv.stop()


def _jax_segments(buf):
    """The JAX IOBuf's contents as numpy: bytes, or (array, mesh index)."""
    out = []
    for i in range(buf.backing_block_num()):
        r = buf.backing_block(i)
        if r.block.kind == 2:        # DEVICE
            arr = np.asarray(r.block.data)[r.offset:r.offset + r.length]
            out.append((arr, jdp.mesh_index_of(r.block.data)))
        else:
            out.append(bytes(r.block.host_view(r.offset, r.length)))
    return out


@pytest.mark.parametrize("nbytes,plane_calls", [(512, 0), (4096, 2),
                                                (256 * 1024, 2)])
def test_echo_matches_jax_package(servers, port_mesh, nbytes, plane_calls):
    import jax
    pch, jch = servers
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)
    msg = f"echo-{nbytes}"

    jcntl = jrpc.Controller()
    jcntl.request_attachment.append(b"hdr:")
    jcntl.request_attachment.append_device_array(
        jax.device_put(data, JaxMesh.default().device(1)))
    jplane = jdp.plane()
    j0 = jplane.stats()["transfers"]
    jresp = jch.call_method("EchoService.Echo", jcntl,
                            JEchoRequest(message=msg), JEchoResponse)
    assert not jcntl.failed(), jcntl.error_text
    jtransfers = jplane.stats()["transfers"] - j0

    # the same attachment rebuilt in the port from the JAX export
    pcntl = rpc.Controller()
    pcntl.request_attachment.append(iobuf_from_segments(
        _jax_segments(jcntl.request_attachment), port_mesh))
    assert pcntl.request_attachment.to_bytes() == \
        jcntl.request_attachment.to_bytes()
    p0 = dp.plane().stats()["transfers"]
    presp = pch.call_method("EchoService.Echo", pcntl,
                            EchoRequest(message=msg), EchoResponse)
    assert not pcntl.failed(), pcntl.error_text
    ptransfers = dp.plane().stats()["transfers"] - p0

    assert presp.SerializeToString() == jresp.SerializeToString()
    assert presp.message == msg
    got = pcntl.response_attachment.to_bytes()
    assert got == jcntl.response_attachment.to_bytes()
    assert got == b"hdr:" + data.tobytes()
    # request leg plus response leg on the plane, the same in both
    assert ptransfers == jtransfers == plane_calls
    # the echoed device bytes are resident on the client's rank in both
    jranks = {jdp.mesh_index_of(r.block.data)
              for r in jcntl.response_attachment.device_refs()}
    pranks = {port_mesh.rank_of(r.block.data)
              for r in pcntl.response_attachment.device_refs()}
    assert jranks == pranks == {1}


def test_unknown_method_fails_like_jax(servers):
    pch, jch = servers
    pcntl, jcntl = rpc.Controller(), jrpc.Controller()
    pch.call_method("EchoService.Nope", pcntl, EchoRequest(message="x"),
                    EchoResponse)
    jch.call_method("EchoService.Nope", jcntl, JEchoRequest(message="x"),
                    JEchoResponse)
    assert pcntl.failed() and jcntl.failed()
    assert pcntl.error_code == jcntl.error_code == rpc.errors.ENOMETHOD


def test_async_call_completes_through_done(servers, port_mesh):
    pch, _ = servers
    got = []
    cntl = rpc.Controller()
    cntl.request_attachment.append_device_array(
        port_mesh.device_put(torch.arange(2048, dtype=torch.uint8), 1))
    pch.call_method("EchoService.Echo", cntl, EchoRequest(message="a"),
                    EchoResponse, done=got.append)
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        time.sleep(0.005)
    assert got == [cntl] and not cntl.failed()
    assert cntl.response.message == "a"
    assert torch.equal(torch.frombuffer(bytearray(
        cntl.response_attachment.to_bytes()), dtype=torch.uint8),
        torch.arange(2048, dtype=torch.uint8))


class TestIciWindow:
    """Transport-level sliding window (reference rdma_endpoint.cpp:771
    window check, :926 completion-driven free), as tests/test_ici.py."""

    def _pair(self, mesh, window, a_dev=0, b_dev=0):
        a = T.IciSocket(a_dev, b_dev, mesh, window_bytes=window)
        b = T.IciSocket(b_dev, a_dev, mesh, window_bytes=window)
        a.peer, b.peer = b, a
        return a, b

    def test_slow_reader_bounds_memory_and_stalls_writer(self, port_mesh):
        win = 8 * 1024
        a, b = self._pair(port_mesh, win)
        chunk = 4 * 1024
        total = 10 * chunk
        done_codes = []
        for _ in range(total // chunk):
            assert a.write(IOBuf(b"x" * chunk),
                           on_done=lambda ec: done_codes.append(ec)) == 0
        # nobody reads: the peer inbox must stay bounded by the window
        deadline = time.monotonic() + 2
        while time.monotonic() < deadline and len(b._inbox) < win:
            time.sleep(0.01)
        assert len(b._inbox) <= win
        assert a.send_window_left() == 0
        assert a.unacked_send_bytes() == win
        # reader drains: writer must resume and deliver everything
        portal = IOPortal()
        got = 0
        deadline = time.monotonic() + 10
        while got < total and time.monotonic() < deadline:
            n = b._do_read(portal, 1 << 20)
            if n <= 0:
                time.sleep(0.005)
                continue
            got += n
        assert got == total, f"delivered {got}/{total}"
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(done_codes) < total // chunk:
            time.sleep(0.01)
        assert done_codes == [0] * (total // chunk)
        a.set_failed()
        b.set_failed()

    def test_window_replenishes_exactly_consumed_bytes(self, port_mesh):
        win = 4096
        a, b = self._pair(port_mesh, win)
        assert a.write(IOBuf(b"y" * 3000)) == 0
        assert a.send_window_left() == win - 3000
        portal = IOPortal()
        assert b._do_read(portal, 1000) == 1000
        assert a.send_window_left() == win - 2000
        assert b._do_read(portal, 1 << 20) == 2000
        assert a.send_window_left() == win
        a.set_failed()
        b.set_failed()

    @pytest.mark.parametrize("nbytes,route", [(1000, "device_put"),
                                              (8192, "plane")])
    def test_source_blocks_pinned_until_copy_complete(self, port_mesh,
                                                      nbytes, route):
        """A cross-rank write pins the SOURCE block until its copy
        completed, on both routes (below and above the threshold)."""
        a, b = self._pair(port_mesh, 1 << 20, a_dev=0, b_dev=1)
        freed = []
        t0 = dp.plane().stats()["transfers"]
        src = port_mesh.device_put(torch.arange(nbytes).to(torch.uint8), 0)
        buf = IOBuf()
        buf.append_device_array(src)
        buf.backing_block(0).block.on_send_complete = \
            lambda: freed.append(1)
        assert a.write(buf) == 0
        portal = IOPortal()
        deadline = time.monotonic() + 5
        got = 0
        while got < nbytes and time.monotonic() < deadline:
            n = b._do_read(portal, 1 << 20)
            got += max(0, n)
            if n <= 0:
                time.sleep(0.005)
        assert got == nbytes
        assert freed == [1], "source block completion hook fired once"
        assert a.inflight_send_blocks() == 0
        moved = dp.plane().stats()["transfers"] - t0
        assert moved == (1 if route == "plane" else 0)
        refs = portal.device_refs()
        assert [port_mesh.rank_of(r.block.data) for r in refs] == [1]
        assert portal.to_bytes() == bytes(src.numpy())
        a.set_failed()
        b.set_failed()

    def test_cross_device_payload_fails_the_write_instead_of_copying(self):
        """Ranks on two devices: a plane-sized payload is refused by the
        plane (its cross-card leg is not built) and the write fails; it
        is never moved by mesh.device_put instead."""
        mesh = IciMesh(ranks=2, device="cpu")
        src = mesh.device_put(torch.arange(4096).to(torch.uint8), 0)
        mesh.devices = [torch.device("cpu"), torch.device("meta")]
        a, b = self._pair(mesh, 1 << 20, a_dev=0, b_dev=1)
        put = []
        mesh.device_put = lambda t, rank: put.append(rank)
        codes = []
        t0 = dp.plane().stats()["transfers"]
        pending = dp.plane().pending_sends()
        buf = IOBuf()
        buf.append_device_array(src)
        a.write(buf, on_done=codes.append)
        deadline = time.monotonic() + 5
        while not codes and time.monotonic() < deadline:
            time.sleep(0.005)
        assert codes and codes[0] != 0
        assert a.failed
        assert put == []
        assert dp.plane().stats()["transfers"] == t0
        assert dp.plane().pending_sends() == pending
        assert len(b._inbox) == 0
        b.set_failed()


class TestOrderedDelivery:
    class _Host(T.OrderedDelivery):
        def __init__(self):
            self._init_delivery()

    def test_host_frame_cannot_jump_pending_device_frame(self, monkeypatch):
        """A host-only frame behind a device-bearing frame whose copy is
        still in flight must wait for it (the parsers rely on transport
        ordering)."""
        h = self._Host()
        order = []
        pending = []

        class FakeDisp:
            def on_ready(self, arrays, cb):
                pending.append(cb)

        monkeypatch.setattr(T, "_all_ready", lambda arrays: False)
        monkeypatch.setattr(T.DeviceEventDispatcher, "instance",
                            classmethod(lambda cls: FakeDisp()))
        h._enqueue_delivery([object()], lambda: order.append(1))
        h._enqueue_delivery([], lambda: order.append(2))
        assert order == []          # 2 must not jump ahead of pending 1
        pending[0]()                # device payload lands
        assert order == [1, 2]

    def test_host_frame_waits_for_pending_plane_transfer(self):
        """The same rule when the gate is a device-plane transfer (its
        completion is the CQ entry)."""
        from brpc_tpu_torch.bthread.device_waiter import DeviceCompletion
        h = self._Host()
        order = []
        cq = DeviceCompletion()
        h._enqueue_delivery([cq], lambda: order.append(1))
        h._enqueue_delivery([], lambda: order.append(2))
        assert order == []
        cq.signal(0)
        assert order == [1, 2]


def test_port_pools_drain_after_failed_sockets(port_mesh):
    """Sockets that were failed leave the port's pool (what the module
    teardown census relies on)."""
    a = T.IciSocket(2, 3, port_mesh)
    b = T.IciSocket(3, 2, port_mesh)
    a.peer, b.peer = b, a
    ids = {a.id, b.id}
    assert ids <= {s.id for s in rpc.list_sockets()}
    a.set_failed()
    b.set_failed()
    gc.collect()
    assert not ids & {s.id for s in rpc.list_sockets()}
