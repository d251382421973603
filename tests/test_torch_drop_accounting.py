"""Launches against calls received on the port's two in-process ici:// doors.

A DEVICE attachment at or above ``ici_device_plane_threshold`` is relocated
on the device plane (one ``p2p_copy`` launch) before its frame reaches the
server.  When the server side fails or bounces the request in between, the
launch ran and no handler counts the call: the port counts such transfers
as dropped, so launches = transfers = received + dropped holds through a
stop.  The failed call keeps the code and retry the JAX package gives it.

* the Python plane: the peer socket fails between ``IciSocket._relocate``
  and ``IciSocket._deliver`` (a hook in ``_deliver``), and a frame left in a
  failed socket's inbox;
* the native door: the lame duck's ELOGOFF bounce, which comes before the
  method's ``received`` count in both packages.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import brpc_tpu_torch.policy  # noqa: F401  (registers protocols)
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici import native_plane, transport
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")
_PAYLOAD = 64 * 1024


@pytest.fixture
def mesh(monkeypatch):
    saved = {n: flags.get_flag(n) for n in _FLAGS}
    m = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(m)
    flags.set_flag("ici_device_plane", True)
    flags.set_flag("ici_device_plane_host_mesh", True)
    flags.set_flag("ici_device_plane_threshold", 4096)
    # the module (the package exports its wrapper under the same name)
    p2p = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    launches = []
    real = p2p.p2p_copy_plain

    def counted(s, d):
        launches.append(s.numel())
        return real(s, d)
    monkeypatch.setattr(p2p, "p2p_copy_plain", counted)
    yield m, launches
    for n, v in saved.items():
        flags.set_flag(n, v)
    IciMesh.set_default(None)


def _sink(seen):
    class Sink(rpc.Service):
        SERVICE_NAME = "Sink"

        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            seen.append(len(cntl.request_attachment))
            response.message = request.message
            done()

    return Sink()


def _server(dev, seen, native):
    server = rpc.Server(rpc.ServerOptions(native_ici=native))
    assert server.add_service(_sink(seen)) == 0
    assert server.start(f"ici://{dev}") == 0
    return server


def _push(ch, mesh, seed):
    data = np.random.default_rng(seed).integers(0, 256, _PAYLOAD,
                                                dtype=np.uint8)
    cntl = rpc.Controller()
    cntl.request_attachment.append_device_array(
        mesh.own(torch.from_numpy(data), 1))
    ch.call_method("Sink.Push", cntl, EchoRequest(message="x"),
                   EchoResponse)
    return cntl


def _received(server):
    return server.method_status("Sink.Push").received.get_value()


def _dropped():
    return (transport.dropped_transfers()
            + native_plane.relocation_stats()["dropped"])


def test_peer_failing_between_relocate_and_deliver_counts_a_drop(
        mesh, monkeypatch):
    m, launches = mesh
    seen = []
    server = _server(4, seen, native=False)
    ch = rpc.Channel()
    ch.init("ici://4", options=rpc.ChannelOptions(timeout_ms=5000,
                                                  max_retry=0))
    try:
        assert not _push(ch, m, 1).failed()
        real = transport.IciSocket._deliver
        hit = []

        def deliver(self, peer, chunks):
            # the window: the relocation (and its launch) is done, and
            # the server's socket fails before the frame is delivered
            if not hit and any(isinstance(c, transport._PlaneDesc)
                               for c in chunks):
                hit.append(1)
                peer.set_failed(errors.EFAILEDSOCKET, "peer stopped")
            return real(self, peer, chunks)
        monkeypatch.setattr(transport.IciSocket, "_deliver", deliver)
        launches0, dropped0 = len(launches), _dropped()
        transfers0 = dp.plane().stats()["transfers"]
        received0 = _received(server)
        cntl = _push(ch, m, 2)
        assert hit == [1]
        # the peer's close reaches the caller as the end of its stream,
        # the code the JAX transport gives it; the accounting changes no
        # call's outcome
        assert cntl.failed()
        assert cntl.error_code_ == errors.EEOF, cntl.error_text
        monkeypatch.setattr(transport.IciSocket, "_deliver", real)
        # a fresh connection serves again
        assert not _push(ch, m, 3).failed()
        got = {"launches": len(launches) - launches0,
               "transfers": dp.plane().stats()["transfers"] - transfers0,
               "received": _received(server) - received0,
               "dropped": _dropped() - dropped0}
        assert got == {"launches": 2, "transfers": 2, "received": 1,
                       "dropped": 1}
        assert seen == [_PAYLOAD, _PAYLOAD]
    finally:
        ch.close()
        server.stop()
        server.join()


def test_failed_socket_drops_its_unread_inbox(mesh):
    """A plane frame committed to an inbox that no reader parsed before
    its socket failed counts once, at the failure; one handed to a socket
    that already failed counts at its commit."""
    m, launches = mesh
    a = transport.IciSocket(1, 2, m)
    b = transport.IciSocket(2, 1, m)
    a.peer, b.peer = b, a           # b has no messenger: nothing reads

    def plane_frame(seed):
        src = m.own(torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, _PAYLOAD, dtype=np.uint8)), 1)
        t = dp.plane().post_send(src, 1, 2, mesh=m)
        return [b"hdr", transport._PlaneDesc(t, _PAYLOAD)]

    dropped0, launches0 = transport.dropped_transfers(), len(launches)
    a._deliver(b, plane_frame(1))
    assert len(b._inbox) == 3 + _PAYLOAD
    assert transport.dropped_transfers() == dropped0
    b.set_failed(errors.EFAILEDSOCKET, "stopped")
    assert transport.dropped_transfers() == dropped0 + 1
    a._deliver(b, plane_frame(2))
    assert transport.dropped_transfers() == dropped0 + 2
    assert len(launches) - launches0 == 2
    a.set_failed(errors.EFAILEDSOCKET, "stopped")
    assert transport.dropped_transfers() == dropped0 + 2


@pytest.mark.skipif(not native_plane.available(),
                    reason="the port's native core is unavailable")
def test_native_lame_duck_bounce_counts_a_drop(mesh):
    m, launches = mesh
    seen = []
    server = _server(5, seen, native=True)
    ch = rpc.Channel()
    ch.init("ici://5", options=rpc.ChannelOptions(timeout_ms=5000,
                                                  max_retry=0))
    try:
        assert not _push(ch, m, 1).failed()
        launches0, dropped0 = len(launches), _dropped()
        transfers0 = dp.plane().stats()["transfers"]
        received0 = _received(server)
        # the drain's flip, as stop(grace) makes it, while the door is
        # still open
        server._draining = True
        cntl = _push(ch, m, 2)
        server._draining = False
        assert cntl.error_code_ == errors.ELOGOFF, cntl.error_text
        assert not _push(ch, m, 3).failed()
        got = {"launches": len(launches) - launches0,
               "transfers": dp.plane().stats()["transfers"] - transfers0,
               "received": _received(server) - received0,
               "dropped": _dropped() - dropped0}
        assert got == {"launches": 2, "transfers": 2, "received": 1,
                       "dropped": 1}
        assert seen == [_PAYLOAD, _PAYLOAD]
    finally:
        ch.close()
        server.stop()
        server.join()
