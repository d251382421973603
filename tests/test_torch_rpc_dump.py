"""rpc_dump and rpc_replay: the port held against the JAX package on the
CPU.

  * ``test_tools.py::test_dump_then_replay`` on both packages over
    ``mem://``;
  * one request frame written to both packages' servers, with a host
    attachment over ``mem://`` and with a DEVICE attachment over ``ici://``
    (the JAX server on its Python plane, ``native_ici=False``; the port on
    a CPU mesh with its device plane engaged): the dump files are equal
    byte for byte, and equal the frame sent;
  * rotation keeps the same files with the same frames on both;
  * sixteen calls with DEVICE attachments dumped on the port and replayed
    against a fresh server: the replayed frames equal the dumped ones but
    for their correlation ids, and the answers are equal;
  * the fabric's plane-frame trace: the same frames written through both
    packages' ``maybe_dump_fabric_frame`` give equal files and equal
    records, and nothing is written with ``rpc_dump`` off.  The wire
    order on two processes is ``tests/test_torch_chaos_fabric.py``'s.
"""
from __future__ import annotations

import io
import os
import time

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import flags as jfl
from brpc_tpu.butil.endpoint import parse_endpoint as jparse
from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.ici.mesh import IciMesh as JaxMesh
from brpc_tpu.rpc import rpc_dump as jdump
from brpc_tpu.rpc.input_messenger import InputMessenger as JMessenger
from brpc_tpu.rpc.socket_map import SocketMap as JSocketMap
from brpc_tpu.tools import rpc_replay as jreplay
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags as tfl
from brpc_tpu_torch.butil.endpoint import parse_endpoint as tparse
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import tpu_std
from brpc_tpu_torch.proto import rpc_meta_pb2 as meta_pb
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import rpc_dump as tdump
from brpc_tpu_torch.rpc.controller import server_controller_pool
from brpc_tpu_torch.rpc.input_messenger import InputMessenger
from brpc_tpu_torch.rpc.socket_map import SocketMap
from brpc_tpu_torch.tools import rpc_replay as treplay
from tests.echo_pb2 import (EchoRequest as JEchoRequest,
                            EchoResponse as JEchoResponse)

_FLAGS = ("rpc_dump", "rpc_dump_dir", "rpc_dump_max_files",
          "rpc_dump_max_requests_in_one_file", "mem_loopback_fast")
_PLANE = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")

_seq = [0]


def unique(p):
    _seq[0] += 1
    return f"dump-{p}-{_seq[0]}"


def _port_idle():
    return (not rpc.list_sockets() and server_controller_pool.live() == 0
            and dp.plane().active_transfers() == 0)


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    yield
    deadline = time.monotonic() + 3.0
    while not _port_idle() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _port_idle(), rpc.list_sockets()


@pytest.fixture(autouse=True)
def dump_flags(tmp_path):
    """Dump flags saved and restored on both packages; each test starts a
    fresh file (the JAX module keeps its open file across a change of
    directory, so it is closed here)."""
    tsaved = {n: tfl.get_flag(n) for n in _FLAGS[:-1]}
    jsaved = {n: jfl.get_flag(n) for n in _FLAGS}
    for mod in (jdump, tdump):
        with mod._lock:
            if mod._current_file is not None:
                mod._current_file.close()
            mod._current_file = None
            mod._current_count = 0
    jfl.set_flag("mem_loopback_fast", False)
    yield tmp_path
    for f in (jfl, tfl):
        f.set_flag("rpc_dump", False)
    for n, v in jsaved.items():
        jfl.set_flag(n, v)
    for n, v in tsaved.items():
        tfl.set_flag(n, v)


def _set_dump(flags, d, on=True, **kw):
    flags.set_flag("rpc_dump_dir", str(d))
    for k, v in kw.items():
        flags.set_flag(k, v)
    flags.set_flag("rpc_dump", on)


class PortEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()


class JaxEcho(jrpc.Service):
    SERVICE_NAME = "EchoService"

    @jrpc.method(JEchoRequest, JEchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()


def _start(pkg_rpc, svc, target, **opts):
    server = pkg_rpc.Server(pkg_rpc.ServerOptions(**opts) if opts else None)
    server.add_service(svc)
    assert server.start(target) == 0
    return server


@pytest.mark.parametrize("which", ["jax", "port"])
def test_dump_then_replay(dump_flags, which):
    """Five calls dumped, then replayed twice against the same server."""
    if which == "jax":
        pkg_rpc, flags, dump, replay, svc, Req, Resp = (
            jrpc, jfl, jdump, jreplay, JaxEcho(), JEchoRequest,
            JEchoResponse)
    else:
        pkg_rpc, flags, dump, replay, svc, Req, Resp = (
            rpc, tfl, tdump, treplay, PortEcho(), EchoRequest, EchoResponse)
    d = dump_flags / which
    target = f"mem://{unique(which)}"
    server = _start(pkg_rpc, svc, target)
    try:
        _set_dump(flags, d)
        ch = pkg_rpc.Channel()
        ch.init(target)
        for i in range(5):
            cntl = pkg_rpc.Controller()
            ch.call_method("EchoService.Echo", cntl, Req(message=f"d{i}"),
                           Resp)
            assert not cntl.failed()
        flags.set_flag("rpc_dump", False)
        files = dump.list_dump_files(str(d))
        assert files
        assert len(dump.load_dumped_frames(files[0])) == 5
        result = replay.run_replay(target, str(d), times=2,
                                   out=io.StringIO())
        assert result["sent"] == 10 and result["ok"] == 10
        ch.close()
    finally:
        flags.set_flag("rpc_dump", False)
        server.stop()


def _frame(cid: int, message: str, attachment: bytes) -> bytes:
    """A tpu_std request frame with a fixed correlation id, the same bytes
    the JAX package packs for it."""
    meta = meta_pb.RpcMeta()
    meta.request.service_name = "EchoService"
    meta.request.method_name = "Echo"
    meta.request.log_id = 7
    meta.correlation_id = cid
    body = EchoRequest(message=message).SerializeToString()
    if attachment:
        meta.attachment_size = len(attachment)
    ms = meta.SerializeToString()
    return (tpu_std.MAGIC + len(ms).to_bytes(4, "big")
            + (len(body) + len(attachment)).to_bytes(4, "big") + ms + body
            + attachment)


def _wait_file(dump, d, n_frames):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        files = dump.list_dump_files(str(d))
        if files and len(dump.load_dumped_frames(files[-1])) >= n_frames:
            return files
        time.sleep(0.01)
    raise AssertionError(f"no dump of {n_frames} frames in {d}")


def test_dump_bytes_equal_jax_host_attachment(dump_flags):
    """One frame with a host attachment, written over mem:// to both
    packages' servers: the two dump files are equal byte for byte."""
    att = bytes(np.random.default_rng(1).integers(0, 256, 3000,
                                                  dtype=np.uint8))
    frame = _frame(0x51, "host", att)
    got = {}
    for which in ("jax", "port"):
        d = dump_flags / which
        target = f"mem://{unique(which)}"
        if which == "jax":
            server = _start(jrpc, JaxEcho(), target)
            sock = JSocketMap.instance().get_socket(
                jparse(target), JMessenger(server=None))
            buf, flags, dump = JIOBuf(), jfl, jdump
        else:
            server = _start(rpc, PortEcho(), target)
            sock = SocketMap.instance().get_socket(
                tparse(target), InputMessenger(server=None))
            buf, flags, dump = IOBuf(), tfl, tdump
        try:
            _set_dump(flags, d)
            buf.append(frame)
            assert sock.write(buf) == 0
            files = _wait_file(dump, d, 1)
            with open(files[-1], "rb") as f:
                got[which] = f.read()
        finally:
            flags.set_flag("rpc_dump", False)
            sock.set_failed()
            server.stop()
    assert got["jax"] == got["port"] == frame


def test_dump_bytes_equal_jax_device_attachment(dump_flags):
    """The same frame with its attachment in a DEVICE block, over ici://
    (rank 1 to rank 2): the port's dump reads the block after its plane
    copy, and the file equals the JAX package's byte for byte."""
    import jax
    att_np = np.random.default_rng(2).integers(0, 256, 8192,
                                               dtype=np.uint8)
    att = bytes(att_np)
    frame = _frame(0x52, "device", att)
    head = frame[:-len(att)]
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    tsaved = {n: tfl.get_flag(n) for n in _PLANE}
    jsaved = {n: jfl.get_flag(n) for n in _PLANE}
    for f in (tfl, jfl):
        f.set_flag("ici_device_plane", True)
        f.set_flag("ici_device_plane_host_mesh", True)
        f.set_flag("ici_device_plane_threshold", 1024)
    got = {}
    try:
        for which in ("jax", "port"):
            d = dump_flags / which
            if which == "jax":
                server = _start(jrpc, JaxEcho(), "ici://2", native_ici=False)
                sock = JSocketMap.instance().get_socket(
                    jparse("ici://2"), JMessenger(server=None))
                buf = JIOBuf()
                buf.append(head)
                buf.append_device_array(jax.device_put(
                    att_np, JaxMesh.default().device(1)))
                flags, dump = jfl, jdump
            else:
                server = _start(rpc, PortEcho(), "ici://2")
                sock = SocketMap.instance().get_socket(
                    tparse("ici://2"), InputMessenger(server=None))
                buf = IOBuf()
                buf.append(head)
                buf.append_device_array(mesh.device_put(
                    torch.from_numpy(att_np.copy()), 1))
                flags, dump = tfl, tdump
            t0 = dp.plane().stats()["transfers"]
            try:
                _set_dump(flags, d)
                assert sock.write(buf) == 0
                files = _wait_file(dump, d, 1)
                with open(files[-1], "rb") as f:
                    got[which] = f.read()
                if which == "port":
                    # the attachment crossed on the plane before the dump
                    assert dp.plane().stats()["transfers"] - t0 >= 1
            finally:
                flags.set_flag("rpc_dump", False)
                sock.set_failed()
                server.stop()
    finally:
        for n, v in tsaved.items():
            tfl.set_flag(n, v)
        for n, v in jsaved.items():
            jfl.set_flag(n, v)
        IciMesh.set_default(None)
    assert got["jax"] == got["port"] == frame


def test_rotation_keeps_the_same_files(dump_flags):
    """Three requests a file, two files kept: eight frames leave the same
    two files with the same frames on both packages."""
    kept = {}
    for which in ("jax", "port"):
        d = dump_flags / which
        target = f"mem://{unique(which)}"
        if which == "jax":
            server = _start(jrpc, JaxEcho(), target)
            sock = JSocketMap.instance().get_socket(
                jparse(target), JMessenger(server=None))
            mk, flags, dump = JIOBuf, jfl, jdump
        else:
            server = _start(rpc, PortEcho(), target)
            sock = SocketMap.instance().get_socket(
                tparse(target), InputMessenger(server=None))
            mk, flags, dump = IOBuf, tfl, tdump
        try:
            _set_dump(flags, d, rpc_dump_max_requests_in_one_file=3,
                      rpc_dump_max_files=2)
            for i in range(8):
                buf = mk()
                buf.append(_frame(0x60 + i, f"r{i}", b""))
                assert sock.write(buf) == 0
                deadline = time.monotonic() + 5
                while dump.dumped_count.get_value() == 0 and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
                time.sleep(0.01)
            files = _wait_file(dump, d, 2)
            kept[which] = [dump.load_dumped_frames(p) for p in files]
        finally:
            flags.set_flag("rpc_dump", False)
            sock.set_failed()
            server.stop()
    assert kept["jax"] == kept["port"]
    assert [len(f) for f in kept["port"]] == [3, 2]


def test_device_calls_dump_and_replay_against_a_fresh_server(dump_flags):
    """Sixteen calls with DEVICE attachments dumped on ici://, then
    replayed against a fresh server that dumps them too: the replayed
    frames equal the dumped ones but for the correlation id, and the
    replay's answers equal the calls'."""
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    tsaved = {n: tfl.get_flag(n) for n in _PLANE}
    tfl.set_flag("ici_device_plane", True)
    tfl.set_flag("ici_device_plane_host_mesh", True)
    tfl.set_flag("ici_device_plane_threshold", 1024)
    rng = np.random.default_rng(3)
    try:
        # the Python plane: rpc_dump samples in its tpu_std server path,
        # and the native door dumps nothing, as the reference's does not
        server = _start(rpc, PortEcho(), "ici://3", native_ici=False)
        ch = rpc.Channel()
        ch.init("ici://3", options=rpc.ChannelOptions(timeout_ms=10000))
        answers = []
        try:
            _set_dump(tfl, dump_flags / "first")
            for i in range(16):
                data = rng.integers(0, 256, 4096, dtype=np.uint8)
                cntl = rpc.Controller()
                cntl.request_attachment.append_device_array(
                    mesh.device_put(torch.from_numpy(data), 1))
                resp = ch.call_method("EchoService.Echo", cntl,
                                      EchoRequest(message=f"q{i}"),
                                      EchoResponse)
                assert not cntl.failed()
                answers.append((0, resp.SerializeToString(),
                                cntl.response_attachment.to_bytes()))
            tfl.set_flag("rpc_dump", False)
        finally:
            ch.close()
            server.stop()
        first = tdump.list_dump_files(str(dump_flags / "first"))
        dumped = [fr for p in first for fr in tdump.load_dumped_frames(p)]
        assert len(dumped) == 16
        fresh = _start(rpc, PortEcho(), "ici://4", native_ici=False)
        try:
            _set_dump(tfl, dump_flags / "replayed")
            result = treplay.run_replay("ici://4", str(dump_flags / "first"),
                                        out=io.StringIO(), collect=True)
            tfl.set_flag("rpc_dump", False)
        finally:
            fresh.stop()
        assert result["sent"] == result["ok"] == 16
        assert result["responses"] == answers
        again = tdump.list_dump_files(str(dump_flags / "replayed"))
        replayed = [fr for p in again for fr in tdump.load_dumped_frames(p)]

        def strip_cid(fr):
            size = int.from_bytes(fr[4:8], "big")
            meta = meta_pb.RpcMeta()
            meta.ParseFromString(fr[12:12 + size])
            meta.correlation_id = 0
            meta.request.ClearField("timeout_ms")
            meta.request.ClearField("deadline_left_ms")
            return meta.SerializeToString(), fr[12 + size:]

        # the server takes the replayed frames concurrently: their dump
        # order is the server's, so they compare as a multiset
        assert sorted(strip_cid(f) for f in replayed) == \
            sorted(strip_cid(f) for f in dumped)
    finally:
        for n, v in tsaved.items():
            tfl.set_flag(n, v)
        IciMesh.set_default(None)


class _TraceSock:
    def __init__(self, sid):
        self.id = sid


_PLANE_HANDSHAKE = [
    (8, "out", b""), (9, "out", b'{"bulk_key": "bulk-7f3a"}'),
    (10, "in", b""), (17, "out", b""),
    (18, "out", b'{"shm_seg": "brpc_tpu_torch_shm.1.ab12"}'),
    (19, "in", b""), (11, "in", b"refused"), (20, "in", b"\x00\x01\xff")]


def test_fabric_trace_records_equal_jax(dump_flags):
    """The trace's record format: one JSON line a frame with ``sock``,
    ``dir``, ``ftype`` and ``body`` in hex, byte for byte as the JAX
    package writes it, read back in the order written."""
    files = {}
    for name, mod, flags in (("jax", jdump, jfl), ("port", tdump, tfl)):
        d = dump_flags / name
        _set_dump(flags, d, on=False)
        assert mod.maybe_dump_fabric_frame(_TraceSock(5), "out", 8,
                                           b"") is False
        assert mod.load_fabric_trace(str(d)) == []
        _set_dump(flags, d)
        for i, (ftype, direction, body) in enumerate(_PLANE_HANDSHAKE):
            assert mod.maybe_dump_fabric_frame(
                _TraceSock(5 + i % 2), direction, ftype, body) is True
        with open(d / "fabric_planes.trace", "rb") as f:
            files[name] = (f.read(), mod.load_fabric_trace(str(d)))
    assert files["port"] == files["jax"]
    recs = files["port"][1]
    assert [(r["ftype"], r["dir"], bytes.fromhex(r["body"]))
            for r in recs] == _PLANE_HANDSHAKE
    assert [r["sock"] for r in recs] == [5, 6] * 4
