"""The native ici:// plane on both packages: the JAX package's C++ core
(``native/``) with ``brpc_tpu.ici.native_plane``, and the port's own copy
(``brpc_tpu_torch/csrc/ici_native.cpp``) with
``brpc_tpu_torch.ici.native_plane``.

Each case of ``tests/test_native_ici.py`` runs on both, with the same
seeded payloads, and is held to the same answers, error codes, bytes and
custody counts (the device-ref registry and the native attachment table
drain to zero).  The JAX package runs on its 8-device CPU mesh; the port on
an 8-rank CPU mesh whose relocations at or above 1 KiB cross on the device
plane (the plain ``p2p_copy``).  Ranks 0-7 stand in for the reference's
``ici://20``-``ici://29``.  The codec's frames are held byte for byte
against the JAX core's.
"""
from __future__ import annotations

import ctypes
import gc
import socket as pysock
import sys
import threading
import time

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import ici as jici
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil import iobuf as jiobuf
from brpc_tpu.ici import native_plane as jnp_plane
from brpc_tpu.rpc import request_context as jreqctx
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil import iobuf as tiobuf
from brpc_tpu_torch.butil import native as tnative
from brpc_tpu_torch.ici import device_plane as tdp
from brpc_tpu_torch.ici import native_plane as tnp_plane
from brpc_tpu_torch.ici.mesh import IciMesh as TMesh
from brpc_tpu_torch.proto.echo_pb2 import (EchoRequest as TReq,
                                           EchoResponse as TResp)
from brpc_tpu_torch.rpc import request_context as treqctx
from tests.echo_pb2 import EchoRequest as JReq, EchoResponse as JResp
from tests.torch_procs import jax_core_available

pytestmark = pytest.mark.skipif(
    not (jax_core_available() and tnp_plane.available()),
    reason="a native core is unavailable")

_PORT_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
               "ici_device_plane_threshold")


def _data(n, seed=0):
    """The seeded payload bytes every case sends: arange, as the reference
    tests send, unless a seed asks for random bytes."""
    if seed:
        return np.random.default_rng(seed).integers(0, 256, n,
                                                    dtype=np.uint8)
    return np.arange(n, dtype=np.uint8)


class _Jax:
    name = "jax"
    rpc = jrpc
    plane = jnp_plane
    flags = jflags
    iobuf = jiobuf
    reqctx = jreqctx
    Req = JReq
    Resp = JResp

    def __init__(self):
        import jax
        self.mesh = jici.IciMesh(jax.devices())

    def activate(self):
        jici.IciMesh.set_default(self.mesh)

    def payload(self, dev, n=4096, seed=0):
        import jax
        import jax.numpy as jnp
        arr = jax.device_put(jnp.asarray(_data(n, seed)),
                             self.mesh.device(dev))
        jax.block_until_ready(arr)
        return arr

    def rank_of(self, arr):
        devs = list(arr.devices())
        return self.mesh.device_index(devs[0]) if len(devs) == 1 else -1

    def outside(self, n=64):
        """A device array the default mesh does not own."""
        import jax
        import jax.numpy as jnp
        small = jici.IciMesh(jax.devices()[:1])
        jici.IciMesh.set_default(small)
        arr = jax.device_put(jnp.arange(n, dtype=jnp.uint8),
                             jax.devices()[1])
        jax.block_until_ready(arr)
        return arr, lambda a: small.device_index(list(a.devices())[0])

    def view_of(self, buf, n):
        return np.frombuffer(buf, dtype=np.uint8)

    def host_bytes(self, arr):
        return bytes(np.asarray(arr))

    def with_fused(self, fused, make):
        """``make()`` -> (server, channel) with fused dispatch on or off:
        the flag, read at bind and connect, switches both halves."""
        prev = jflags.get_flag("ici_fused_dispatch")
        jflags.set_flag("ici_fused_dispatch", fused)
        try:
            return make()
        finally:
            jflags.set_flag("ici_fused_dispatch", prev)

    def server_bodies(self, binding):
        """(fused, unfused) requests the listener's server bodies took."""
        return binding.fused_dispatched, binding.legacy_dispatched


class _Port:
    name = "port"
    rpc = trpc
    plane = tnp_plane
    flags = tflags
    iobuf = tiobuf
    reqctx = treqctx
    Req = TReq
    Resp = TResp

    def __init__(self):
        self.mesh = TMesh(ranks=8, device="cpu")

    def activate(self):
        TMesh.set_default(self.mesh)

    def payload(self, dev, n=4096, seed=0):
        return self.mesh.device_put(torch.from_numpy(_data(n, seed).copy()),
                                    dev)

    def rank_of(self, arr):
        return TMesh.default().rank_of(arr)

    def outside(self, n=64):
        """A tensor no rank of the mesh owns (the host mesh's device, but
        unregistered): the core upcalls and the copy lands on the rank."""
        return torch.arange(n, dtype=torch.uint8), self.rank_of

    def view_of(self, buf, n):
        return torch.frombuffer(buf, dtype=torch.uint8)

    def host_bytes(self, arr):
        return bytes(arr.cpu().numpy())

    def with_fused(self, fused, make):
        """``make()`` -> (server, channel) with the client's fused path on
        or off (the port's server has one chain)."""
        server, ch = make()
        ch._native_ici_binding(trpc.Controller())._fused = fused
        return server, ch

    def server_bodies(self, binding):
        """The port's server has one chain: no split to report."""
        return None


_PKGS = {}


@pytest.fixture(scope="module", autouse=True)
def _meshes():
    saved = {n: tflags.get_flag(n) for n in _PORT_FLAGS}
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 1024)
    _PKGS["jax"] = _Jax()
    _PKGS["port"] = _Port()
    yield
    for n, v in saved.items():
        tflags.set_flag(n, v)
    TMesh.set_default(None)
    # the module's pools drain: no port socket, server Controller, plane
    # transfer or native custody outlives it
    from brpc_tpu_torch.rpc.controller import server_controller_pool
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and (
            list_sockets() or server_controller_pool.live()
            or tdp.plane().active_transfers()
            or tnp_plane.registry().live()):
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()
    assert server_controller_pool.live() == 0
    assert tdp.plane().active_transfers() == 0
    assert tnp_plane.registry().live() == 0


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    p = _PKGS[request.param]
    p.activate()
    yield p
    if p is _PKGS["port"]:
        TMesh.set_default(p.mesh)


def _echo_service(pkg):
    class EchoService(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            if len(cntl.request_attachment):
                cntl.response_attachment.append(cntl.request_attachment)
            done()

    return EchoService()


def _service(pkg, name, fn):
    """A one-method service ``name``.M whose handler is ``fn(cntl,
    request, response, done)``."""
    svc_cls = type(name, (pkg.rpc.Service,), {"SERVICE_NAME": name})
    method = pkg.rpc.method(pkg.Req, pkg.Resp)(
        lambda self, cntl, request, response, done:
        fn(cntl, request, response, done))
    method.__name__ = "M"
    setattr(svc_cls, "M", method)
    return svc_cls()


def _server(pkg, dev, svc=None, **opts):
    server = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts) if opts else None)
    server.add_service(svc if svc is not None else _echo_service(pkg))
    assert server.start(f"ici://{dev}") == 0
    return server


def _channel(pkg, dev, **opts):
    ch = pkg.rpc.Channel()
    ch.init(f"ici://{dev}", options=pkg.rpc.ChannelOptions(**opts)
            if opts else None)
    return ch


def _drained(pkg):
    deadline = time.monotonic() + 3
    while time.monotonic() < deadline:
        if (pkg.plane.registry().live() == 0
                and pkg.plane.att_table_live() == 0):
            return True
        gc.collect()
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------
# the datapath
# ---------------------------------------------------------------------

class TestNativeDatapath:
    def test_channel_rides_native_plane(self, pkg):
        server = _server(pkg, 2)
        try:
            binding = server._native_ici
            assert binding is not None, "native ici plane not attached"
            ch = _channel(pkg, 2)
            before = binding.requests()
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(0))
            resp = ch.call_method("EchoService.Echo", cntl,
                                  pkg.Req(message="native"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "native"
            assert cntl.response_attachment.to_bytes() == bytes(_data(4096))
            assert binding.requests() == before + 1
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_native_echo_tier_and_relocation(self, pkg):
        """The C++ echo tier answers with no Python dispatch; a payload on
        another rank relocates toward the client's rank on the way back."""
        server = _server(pkg, 3)
        try:
            server._native_ici.register_native_echo("EchoService.Echo")
            ch = _channel(pkg, 3)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(1))
            ch.call_method("EchoService.Echo", cntl, pkg.Req(message="m"),
                           pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            refs = cntl.response_attachment.device_refs()
            assert len(refs) == 1
            local_dev = ch._native_ici.local_dev
            assert local_dev == 4            # the neighbour of ici://3
            assert pkg.rank_of(refs[0].block.data) == local_dev
            assert cntl.response_attachment.to_bytes() == bytes(_data(4096))
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_handler_sees_resident_attachment(self, pkg):
        """The handler's device refs already live on the server's rank:
        relocation ran before the upcall."""
        seen = {}

        def probe(cntl, request, response, done):
            refs = cntl.request_attachment.device_refs()
            seen["ranks"] = {pkg.rank_of(r.block.data) for r in refs}
            seen["bytes"] = cntl.request_attachment.to_bytes()
            response.message = "ok"
            done()

        server = _server(pkg, 4, _service(pkg, "Probe", probe))
        try:
            ch = _channel(pkg, 4)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(
                pkg.payload(2, seed=11))
            ch.call_method("Probe.M", cntl, pkg.Req(message="x"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert seen["ranks"] == {4}
            assert seen["bytes"] == bytes(_data(4096, seed=11))
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_mixed_host_device_attachment_order(self, pkg):
        got = {}

        def mix(cntl, request, response, done):
            att = cntl.request_attachment
            got["bytes"] = att.to_bytes()
            got["kinds"] = [att.backing_block(i).block.kind
                            for i in range(att.backing_block_num())]
            response.message = "ok"
            done()

        server = _server(pkg, 5, _service(pkg, "Mix", mix))
        try:
            ch = _channel(pkg, 5)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append(b"head-")
            cntl.request_attachment.append_device_array(pkg.payload(0, 16))
            cntl.request_attachment.append(b"-tail")
            ch.call_method("Mix.M", cntl, pkg.Req(message="x"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert got["bytes"] == b"head-" + bytes(range(16)) + b"-tail"
            assert got["kinds"][0] == pkg.iobuf.HOST
            assert pkg.iobuf.DEVICE in got["kinds"]
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_error_paths_release_custody(self, pkg):
        server = _server(pkg, 6)
        try:
            ch = _channel(pkg, 6)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(0))
            ch.call_method("NoSuch.Method", cntl, pkg.Req(message="x"),
                           pkg.Resp)
            assert cntl.error_code_ == pkg.rpc.errors.ENOMETHOD
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_error_response_with_segs_releases_on_client(self, pkg,
                                                         monkeypatch):
        """A response with an error AND device segs: the client releases
        the keys on its failure path (exactly one exit per key)."""
        def failing(cntl, request, response, done):
            cntl.set_failed(pkg.rpc.errors.EINTERNAL, "deliberate")
            done()

        server = _server(pkg, 5, _service(pkg, "Failing", failing))
        try:
            binding = server._native_ici
            arr = pkg.payload(0)

            def err_with_segs(token, err, text, collector=None, post=None,
                              retry_after=0):
                att = pkg.iobuf.IOBuf()
                att.append_device_array(arr)
                att_host, segs = pkg.plane.split_attachment(att)
                binding._respond_flush([(token, err, text.encode(), b"",
                                         att_host, segs, post,
                                         retry_after, 0)])

            monkeypatch.setattr(binding, "_respond_one", err_with_segs)
            ch = _channel(pkg, 5)
            cntl = pkg.rpc.Controller()
            ch.call_method("Failing.M", cntl, pkg.Req(message="x"),
                           pkg.Resp)
            assert cntl.error_code_ == pkg.rpc.errors.EINTERNAL
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_timeout_drops_late_response_and_releases(self, pkg):
        release = threading.Event()
        responded = threading.Event()

        def slow(cntl, request, response, done):
            def later():
                release.wait(5)
                if len(cntl.request_attachment):
                    cntl.response_attachment.append(cntl.request_attachment)
                response.message = "late"
                done()
                responded.set()
            threading.Thread(target=later, daemon=True).start()

        server = _server(pkg, 7, _service(pkg, "Slow", slow))
        try:
            ch = _channel(pkg, 7, timeout_ms=150, max_retry=0)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(0))
            ch.call_method("Slow.M", cntl, pkg.Req(message="x"), pkg.Resp)
            assert cntl.error_code_ == pkg.rpc.errors.ERPCTIMEDOUT
            release.set()
            assert responded.wait(5)
            ch.close()
        finally:
            release.set()
            server.stop()
        assert _drained(pkg)

    def test_oversize_frame_fails_fast(self, pkg):
        server = _server(pkg, 1)
        try:
            binding = pkg.plane.ChannelBinding(1, window_bytes=1024)
            try:
                cntl = pkg.rpc.Controller()
                cntl.timeout_ms = 10000
                cntl.request_attachment.append(b"x" * 8192)
                t0 = time.monotonic()
                binding.call("EchoService.Echo", cntl, pkg.Req(message="x"),
                             pkg.Resp)
                assert cntl.error_code_ == pkg.rpc.errors.EOVERCROWDED
                assert time.monotonic() - t0 < 2.0
            finally:
                binding.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_concurrent_callers(self, pkg):
        server = _server(pkg, 1)
        errs = []
        try:
            ch = _channel(pkg, 1)

            def worker(wid):
                try:
                    for i in range(25):
                        cntl = pkg.rpc.Controller()
                        msg = f"w{wid}-{i}"
                        resp = ch.call_method("EchoService.Echo", cntl,
                                              pkg.Req(message=msg),
                                              pkg.Resp)
                        assert not cntl.failed(), cntl.error_text
                        assert resp.message == msg
                except Exception as e:   # pragma: no cover
                    errs.append(e)

            threads = [threading.Thread(target=worker, args=(w,))
                       for w in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errs, errs
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_server_stop_fails_inflight_cleanly(self, pkg):
        """A channel that outlives its server fails its call; a fresh
        server on the same rank serves a fresh channel."""
        server = _server(pkg, 2)
        ch = _channel(pkg, 2)
        cntl = pkg.rpc.Controller()
        ch.call_method("EchoService.Echo", cntl, pkg.Req(message="a"),
                       pkg.Resp)
        assert not cntl.failed()
        server.stop()
        cntl = pkg.rpc.Controller()
        ch.call_method("EchoService.Echo", cntl, pkg.Req(message="b"),
                       pkg.Resp)
        assert cntl.failed()
        ch.close()
        server2 = _server(pkg, 2)
        try:
            ch2 = _channel(pkg, 2)
            cntl = pkg.rpc.Controller()
            resp = ch2.call_method("EchoService.Echo", cntl,
                                   pkg.Req(message="c"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "c"
            ch2.close()
        finally:
            server2.stop()
        assert _drained(pkg)

    def test_server_stop_with_calls_in_flight(self, pkg):
        """A stop with eight native calls in flight: each fails with the
        dead-peer code, and no key and no transfer outlives it."""
        gate = threading.Event()
        entered = []

        def park(cntl, request, response, done):
            entered.append(1)
            gate.wait(5)
            response.message = "late"
            done()

        server = _server(pkg, 6, _service(pkg, "Park", park),
                         usercode_in_pthread=True, usercode_backup_threads=8)
        ch = _channel(pkg, 6, timeout_ms=10000, max_retry=0)
        codes = []
        lock = threading.Lock()

        def one(i):
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(
                pkg.payload(1, seed=100 + i))
            # the binding directly: a stop is then final (the channel
            # would re-route a dead connection's call once)
            ch._native_ici.call("Park.M", cntl, pkg.Req(message=str(i)),
                                pkg.Resp)
            with lock:
                codes.append(cntl.error_code_)

        ch._native_ici_binding(pkg.rpc.Controller())
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while len(entered) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(entered) == 8
        server.stop()
        for t in threads:
            t.join(10)
        gate.set()
        assert codes == [pkg.rpc.errors.EFAILEDSOCKET] * 8, codes
        ch.close()
        server.join(5)
        assert _drained(pkg)
        if pkg.name == "port":
            assert tdp.plane().active_transfers() == 0

    def test_async_done_callback(self, pkg):
        server = _server(pkg, 3)
        try:
            ch = _channel(pkg, 3)
            ev = threading.Event()
            out = {}

            def done(cntl):
                out["failed"] = cntl.failed()
                out["resp"] = cntl.response
                ev.set()

            cntl = pkg.rpc.Controller()
            ch.call_method("EchoService.Echo", cntl,
                           pkg.Req(message="async"), pkg.Resp, done=done)
            assert ev.wait(10)
            assert out["failed"] is False
            assert out["resp"].message == "async"
            ch.close()
        finally:
            server.stop()


class TestReviewFindings:
    def test_channel_survives_server_restart(self, pkg):
        server = _server(pkg, 4)
        ch = _channel(pkg, 4)
        cntl = pkg.rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              pkg.Req(message="one"), pkg.Resp)
        assert not cntl.failed() and resp.message == "one"
        server.stop()
        server2 = _server(pkg, 4)
        try:
            cntl = pkg.rpc.Controller()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  pkg.Req(message="two"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "two"
            ch.close()
        finally:
            server2.stop()
        assert _drained(pkg)

    def test_oversize_attachment_falls_back_to_python_plane(self, pkg):
        """6 MiB of host attachment is over the 4 MiB native window: the
        call rides the Python plane and is served all the same."""
        server = _server(pkg, 5)
        try:
            before = server._native_ici.requests()
            ch = _channel(pkg, 5, timeout_ms=60000, max_retry=0)
            big = b"z" * (6 * 1024 * 1024)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append(big)
            resp = ch.call_method("EchoService.Echo", cntl,
                                  pkg.Req(message="big"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "big"
            assert cntl.response_attachment.to_bytes() == big
            assert server._native_ici.requests() == before
            ch.close()
        finally:
            server.stop()

    def test_no_deadline_means_no_deadline(self, pkg):
        gate = threading.Event()

        def slowish(cntl, request, response, done):
            def later():
                gate.wait(10)
                response.message = "eventually"
                done()
            threading.Thread(target=later, daemon=True).start()

        server = _server(pkg, 6, _service(pkg, "Slowish", slowish))
        try:
            ch = _channel(pkg, 6, timeout_ms=0)
            out = {}

            def call():
                cntl = pkg.rpc.Controller()
                cntl.timeout_ms = 0
                out["resp"] = ch.call_method("Slowish.M", cntl,
                                             pkg.Req(message="x"), pkg.Resp)
                out["failed"] = cntl.failed()

            t = threading.Thread(target=call, daemon=True)
            t.start()
            time.sleep(0.3)
            assert t.is_alive()
            gate.set()
            t.join(10)
            assert not t.is_alive()
            assert out["failed"] is False
            assert out["resp"].message == "eventually"
            ch.close()
        finally:
            gate.set()
            server.stop()

    def test_out_of_mesh_array_still_relocates(self, pkg):
        """An attachment no rank owns carries rank -1 and is relocated by
        the upcall, never passed through."""
        seen = {}
        outside, rank_of = pkg.outside()

        def probe(cntl, request, response, done):
            refs = cntl.request_attachment.device_refs()
            seen["ranks"] = {rank_of(r.block.data) for r in refs}
            response.message = "ok"
            done()

        server = _server(pkg, 0, _service(pkg, "Probe", probe))
        try:
            ch = _channel(pkg, 0)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(outside)
            ch.call_method("Probe.M", cntl, pkg.Req(message="x"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert seen["ranks"] == {0}
            ch.close()
        finally:
            server.stop()
            pkg.activate()
        assert _drained(pkg)


class TestAsyncPoolSafety:
    def test_async_calls_beyond_pool_size_complete(self, pkg):
        def nap(cntl, request, response, done):
            time.sleep(0.05)
            response.message = request.message
            done()

        server = _server(pkg, 7, _service(pkg, "Nap", nap))
        try:
            ch = _channel(pkg, 7, timeout_ms=10000)
            n = 8
            evs = [threading.Event() for _ in range(n)]
            outs = [None] * n

            def make_done(i):
                def done(cntl):
                    outs[i] = (cntl.failed(), cntl.response)
                    evs[i].set()
                return done

            t0 = time.monotonic()
            for i in range(n):
                ch.call_method("Nap.M", pkg.rpc.Controller(),
                               pkg.Req(message=f"m{i}"), pkg.Resp,
                               done=make_done(i))
            for i, ev in enumerate(evs):
                assert ev.wait(8), f"call {i} never completed"
            assert time.monotonic() - t0 < 8
            for i, (failed, resp) in enumerate(outs):
                assert failed is False
                assert resp.message == f"m{i}"
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)


class TestNativeLoopBench:
    def test_cpp_loop_echo_runs(self, pkg):
        p50 = pkg.plane.native_ici_echo_p50_us(200, 64)
        assert p50 > 0
        p50d = pkg.plane.native_ici_echo_p50_us(
            200, 64, device_array=pkg.payload(0, 1024))
        assert p50d > 0
        assert pkg.plane.registry().live() == 0


class TestFaultInjectionOnFastPlane:
    def test_injected_fault_reaches_native_ici_calls(self, pkg):
        fi = pkg.rpc.fault_injection
        server = _server(pkg, 1)
        try:
            ch = _channel(pkg, 1, timeout_ms=2000, max_retry=0)
            with fi.inject(fi.FaultInjector(error_ratio=1.0)):
                cntl = pkg.rpc.Controller()
                ch.call_method("EchoService.Echo", cntl,
                               pkg.Req(message="x"), pkg.Resp)
                assert cntl.error_code_ == pkg.rpc.errors.EFAILEDSOCKET
            cntl = pkg.rpc.Controller()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  pkg.Req(message="y"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "y"
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)


class TestRelocateCustody:
    def test_relocate_detaches_borrowed_views(self, pkg):
        """A payload that views memory the caller will reuse (a receive
        buffer) is copied by the relocation, never aliased."""
        n = 4096
        raw = (ctypes.c_uint8 * (n + 64))()
        addr = ctypes.addressof(raw)
        buf = (ctypes.c_uint8 * n).from_address(addr + (-addr) % 64)
        np.ctypeslib.as_array(buf)[:] = np.arange(n, dtype=np.uint8) % 251
        view = pkg.view_of(buf, n)
        expect = bytes(np.arange(n, dtype=np.uint8) % 251)
        reg = pkg.plane.registry()
        key = reg.put(view)
        new_key = 0
        try:
            new_key = pkg.plane._relocate(key, 0)
            assert new_key not in (0, key)
            moved = reg.peek(new_key)
            ctypes.memset(buf, 0, n)
            assert pkg.host_bytes(moved) == expect
        finally:
            reg.release(key)
            if new_key and new_key != key:
                reg.release(new_key)


class TestNativeAttCustody:
    def _echo_server(self, pkg, dev, body):
        def echo(cntl, request, response, done):
            body(cntl, request, response)
            done()

        svc = _service(pkg, "EchoService", echo)
        server = _server(pkg, dev, svc)
        ch = _channel(pkg, dev, timeout_ms=10000, max_retry=0,
                      ici_local_device=dev)
        return server, ch

    def test_passthrough_view_is_lazy_and_byte_exact(self, pkg):
        seen = {}

        def body(cntl, request, response):
            att = cntl.request_attachment
            seen["type"] = type(att).__name__
            seen["len"] = len(att)
            seen["mat_before_len"] = att._mat
            response.message = request.message
            cntl.response_attachment = att

        server, ch = self._echo_server(pkg, 0, body)
        try:
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(0))
            resp = ch.call_method("EchoService.M", cntl,
                                  pkg.Req(message="pt"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "pt"
            assert seen == {"type": "NativeAttachment", "len": 4096,
                            "mat_before_len": False}
            out = cntl.response_attachment
            assert type(out).__name__ == "NativeAttachment"
            assert len(out) == 4096 and not out._mat
            assert out.to_bytes() == bytes(_data(4096))
            assert out._mat
            del cntl, out
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_append_pattern_materializes_and_stays_correct(self, pkg):
        def body(cntl, request, response):
            response.message = request.message
            if len(cntl.request_attachment):
                cntl.response_attachment.append(cntl.request_attachment)

        server, ch = self._echo_server(pkg, 1, body)
        try:
            for _ in range(3):
                cntl = pkg.rpc.Controller()
                cntl.request_attachment.append_device_array(pkg.payload(1))
                ch.call_method("EchoService.M", cntl, pkg.Req(message="ap"),
                               pkg.Resp)
                assert not cntl.failed(), cntl.error_text
                assert cntl.response_attachment.to_bytes() == \
                    bytes(_data(4096))
            del cntl
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_ignored_attachment_disposed_at_pool_recycle(self, pkg):
        def body(cntl, request, response):
            response.message = "ok"

        server, ch = self._echo_server(pkg, 2, body)
        try:
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(2))
            ch.call_method("EchoService.M", cntl, pkg.Req(message="x"),
                           pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            del cntl
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_reject_path_disposes_view(self, pkg):
        server = _server(pkg, 3)
        try:
            ch = _channel(pkg, 3, timeout_ms=5000, max_retry=0,
                          ici_local_device=3)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(3))
            ch.call_method("NoSuch.Method", cntl, pkg.Req(message="x"),
                           pkg.Resp)
            assert cntl.error_code_ == pkg.rpc.errors.ENOMETHOD
            del cntl
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_per_request_failure_isolation_disposes_handle(self, pkg):
        def body(cntl, request, response):
            if request.message == "boom":
                raise RuntimeError("deliberate")
            response.message = request.message

        server, ch = self._echo_server(pkg, 4, body)
        try:
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(4))
            ch.call_method("EchoService.M", cntl, pkg.Req(message="boom"),
                           pkg.Resp)
            assert cntl.error_code_ == pkg.rpc.errors.EINTERNAL
            cntl2 = pkg.rpc.Controller()
            cntl2.request_attachment.append_device_array(pkg.payload(4))
            resp = ch.call_method("EchoService.M", cntl2,
                                  pkg.Req(message="fine"), pkg.Resp)
            assert not cntl2.failed() and resp.message == "fine"
            del cntl, cntl2
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_late_passthrough_after_timeout_releases(self, pkg):
        release = threading.Event()
        responded = threading.Event()

        def slow(cntl, request, response, done):
            def later():
                release.wait(5)
                cntl.response_attachment = cntl.request_attachment
                response.message = "late"
                done()
                responded.set()
            threading.Thread(target=later, daemon=True).start()

        server = _server(pkg, 5, _service(pkg, "Slow", slow))
        try:
            ch = _channel(pkg, 5, timeout_ms=150, max_retry=0,
                          ici_local_device=5)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(5))
            ch.call_method("Slow.M", cntl, pkg.Req(message="x"), pkg.Resp)
            assert cntl.error_code_ == pkg.rpc.errors.ERPCTIMEDOUT
            release.set()
            assert responded.wait(5)
            del cntl
            ch.close()
        finally:
            release.set()
            server.stop()
        assert _drained(pkg)

    def test_client_view_del_is_the_release(self, pkg):
        def body(cntl, request, response):
            response.message = "ok"
            cntl.response_attachment = cntl.request_attachment

        server, ch = self._echo_server(pkg, 6, body)
        try:
            for _ in range(4):
                cntl = pkg.rpc.Controller()
                cntl.request_attachment.append_device_array(pkg.payload(6))
                ch.call_method("EchoService.M", cntl, pkg.Req(message="x"),
                               pkg.Resp)
                assert not cntl.failed(), cntl.error_text
            del cntl
            ch.close()
        finally:
            server.stop()
        assert _drained(pkg)

    def test_legacy_mode_byte_identical(self, pkg):
        prev = pkg.flags.get_flag("ici_native_att_custody")
        pkg.flags.set_flag("ici_native_att_custody", False)
        try:
            seen = {}

            def body(cntl, request, response):
                seen["type"] = type(cntl.request_attachment).__name__
                response.message = request.message
                cntl.response_attachment.append(cntl.request_attachment)

            server, ch = self._echo_server(pkg, 7, body)
            try:
                cntl = pkg.rpc.Controller()
                cntl.request_attachment.append_device_array(pkg.payload(7))
                ch.call_method("EchoService.M", cntl, pkg.Req(message="x"),
                               pkg.Resp)
                assert not cntl.failed(), cntl.error_text
                assert seen["type"] == "IOBuf"
                assert type(cntl.response_attachment) is pkg.iobuf.IOBuf
                assert cntl.response_attachment.to_bytes() == \
                    bytes(_data(4096))
                del cntl
                ch.close()
            finally:
                server.stop()
        finally:
            pkg.flags.set_flag("ici_native_att_custody", prev)
        assert _drained(pkg)

    def test_proxy_forwarding_view_as_request(self, pkg):
        inner_server = _server(pkg, 0)
        inner_ch = _channel(pkg, 0, timeout_ms=10000, max_retry=0,
                            ici_local_device=0)

        def body(cntl, request, response):
            inner = pkg.rpc.Controller()
            inner.request_attachment.append(cntl.request_attachment)
            r = inner_ch.call_method("EchoService.Echo", inner,
                                     pkg.Req(message="inner"), pkg.Resp)
            assert not inner.failed(), inner.error_text
            response.message = r.message
            cntl.response_attachment = inner.response_attachment

        server, ch = self._echo_server(pkg, 1, body)
        try:
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(
                pkg.payload(1, seed=9))
            resp = ch.call_method("EchoService.M", cntl,
                                  pkg.Req(message="outer"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "inner"
            assert cntl.response_attachment.to_bytes() == \
                bytes(_data(4096, seed=9))
            del cntl
            ch.close()
            inner_ch.close()
        finally:
            server.stop()
            inner_server.stop()
        assert _drained(pkg)


class TestBuildAttachmentExceptionSafety:
    def test_midwalk_failure_releases_unwalked_keys(self, pkg, monkeypatch):
        reg = pkg.plane.registry()
        base = reg.live()
        arrs = [pkg.payload(0, 256) for _ in range(3)]
        seg_arr = pkg.plane.fill_seg_array(
            [(reg.put(a), 256, 0, 1) for a in arrs])
        calls = {"n": 0}
        if pkg.name == "jax":
            owner, attr = pkg.iobuf.IOBuf, "append_device_array_unchecked"
        else:
            owner, attr = pkg.plane, "_append_device"
        real = getattr(owner, attr)

        def flaky(*args):
            calls["n"] += 1
            if calls["n"] == 2:
                raise MemoryError("injected mid-walk failure")
            return real(*args)

        monkeypatch.setattr(owner, attr, flaky)
        with pytest.raises(MemoryError):
            pkg.plane.build_attachment_from_c(b"", seg_arr, 3)
        assert reg.live() == base

    def test_clean_walk_unchanged(self, pkg):
        reg = pkg.plane.registry()
        arrs = [pkg.payload(0, 128) for _ in range(2)]
        segs = [(reg.put(arrs[0]), 128, 0, 1), (0, 3, 0, 0),
                (reg.put(arrs[1]), 128, 0, 1)]
        buf = pkg.plane.build_attachment_from_c(
            b"abc", pkg.plane.fill_seg_array(segs), 3)
        assert len(buf) == 128 + 3 + 128
        assert buf.to_bytes() == bytes(_data(128)) + b"abc" + \
            bytes(_data(128))
        assert reg.live() == 0


class TestFusedDispatch:
    def _server_channel(self, pkg, dev, fused, service=None, **opts):
        opts.setdefault("usercode_inline", True)

        def make():
            server = _server(pkg, dev, service, **opts)
            return server, _channel(pkg, dev, timeout_ms=10000,
                                    max_retry=0, ici_local_device=dev)

        return pkg.with_fused(fused, make)

    def _echo(self, pkg, ch, msg="m", n=512):
        cntl = pkg.rpc.Controller()
        cntl.request_attachment.append_device_array(pkg.payload(0, n))
        resp = ch.call_method("EchoService.Echo", cntl,
                              pkg.Req(message=msg), pkg.Resp)
        return cntl, resp

    def test_fused_vs_legacy_byte_parity(self, pkg):
        results = {}
        for fused in (True, False):
            server, ch = self._server_channel(pkg, 3, fused)
            try:
                cntl, resp = self._echo(pkg, ch, msg="parity")
                assert not cntl.failed(), cntl.error_text
                results[fused] = (resp.message,
                                  cntl.response_attachment.to_bytes())
                binding = server._native_ici
                assert binding.requests() == 1
                bodies = pkg.server_bodies(binding)
                if bodies is not None:
                    assert bodies == ((1, 0) if fused else (0, 1))
                ch.close()
            finally:
                server.stop()
        assert results[True] == results[False] == ("parity",
                                                   bytes(_data(512)))

    def test_fused_error_paths_match_legacy(self, pkg):
        def boom(cntl, request, response, done):
            raise ValueError("kaboom")

        for fused in (True, False):
            server, ch = self._server_channel(
                pkg, 3, fused, service=_service(pkg, "EchoService", boom))
            try:
                cntl = pkg.rpc.Controller()
                ch.call_method("EchoService.Nope", cntl,
                               pkg.Req(message="x"), pkg.Resp)
                assert cntl.error_code == pkg.rpc.errors.ENOMETHOD
                cntl = pkg.rpc.Controller()
                ch.call_method("EchoService.M", cntl, pkg.Req(message="x"),
                               pkg.Resp)
                assert cntl.error_code == pkg.rpc.errors.EINTERNAL
                assert "kaboom" in cntl.error_text
                cntl = pkg.rpc.Controller()
                ch.call_method("EchoService.M", cntl,
                               b"\xff\xff\xff\xff\xff", None)
                assert cntl.error_code == pkg.rpc.errors.EREQUEST, \
                    cntl.error_text
                ch.close()
            finally:
                server.stop()

    def test_fused_async_handler_and_send_response(self, pkg):
        def handler(cntl, request, response, done):
            if request.message == "sendresp":
                response.message = "via-send-response"
                cntl.send_response()
                return
            response.message = "later"
            threading.Timer(0.03, done).start()

        server, ch = self._server_channel(
            pkg, 3, True, service=_service(pkg, "EchoService", handler))
        try:
            cntl = pkg.rpc.Controller()
            resp = ch.call_method("EchoService.M", cntl,
                                  pkg.Req(message="park"), pkg.Resp)
            assert not cntl.failed() and resp.message == "later"
            cntl = pkg.rpc.Controller()
            resp = ch.call_method("EchoService.M", cntl,
                                  pkg.Req(message="sendresp"), pkg.Resp)
            assert not cntl.failed() and \
                resp.message == "via-send-response"
            ch.close()
        finally:
            server.stop()

    def test_fused_admission_delegates_to_legacy_chain(self, pkg):
        server, ch = self._server_channel(pkg, 3, True, admission=True)
        try:
            cntl, resp = self._echo(pkg, ch, msg="adm")
            assert not cntl.failed(), cntl.error_text
            assert resp.message == "adm"
            binding = server._native_ici
            assert binding.requests() == 1
            bodies = pkg.server_bodies(binding)
            if bodies is not None:
                assert bodies == (0, 1)
            ch.close()
        finally:
            server.stop()

    def test_fused_draining_bounces_elogoff(self, pkg):
        server, ch = self._server_channel(pkg, 3, True)
        try:
            cntl, resp = self._echo(pkg, ch)
            assert not cntl.failed()
            server._draining = True
            cntl = pkg.rpc.Controller()
            ch.call_method("EchoService.Echo", cntl, pkg.Req(message="x"),
                           pkg.Resp)
            assert cntl.error_code == pkg.rpc.errors.ELOGOFF
            ch.close()
        finally:
            server._draining = False
            server.stop()

    def test_fused_context_masking_for_nested_dispatch(self, pkg):
        seen = {}

        def handler(cntl, request, response, done):
            seen["ctx"] = pkg.reqctx.current()
            seen["ddl"] = cntl.deadline_left_ms
            response.message = "ok"
            done()

        server, ch = self._server_channel(
            pkg, 3, True, service=_service(pkg, "EchoService", handler))
        try:
            cntl = pkg.rpc.Controller()
            ch.call_method("EchoService.M", cntl, pkg.Req(message="x"),
                           pkg.Resp)
            assert not cntl.failed()
            assert seen["ctx"] is not None
            assert seen["ctx"].deadline_left_ms == seen["ddl"] > 0
            ch.close()
        finally:
            server.stop()

    def test_frame_budget(self, pkg):
        """Interpreter frames per call on the fused native echo path with
        a resident payload (``sys.setprofile`` around one call): both
        packages stay inside the reference's budget of 60."""
        server, ch = self._server_channel(pkg, 3, True)
        try:
            payload = pkg.payload(3, 512)
            req = pkg.Req(message="f")

            def one():
                cntl = pkg.rpc.Controller()
                cntl.request_attachment.append_device_array(payload)
                return cntl

            for _ in range(30):
                cntl = one()
                ch.call_method("EchoService.Echo", cntl, req, pkg.Resp)
                assert not cntl.failed(), cntl.error_text
            counts = []
            for _ in range(20):
                cntl = one()
                n = [0]

                def prof(frame, event, arg, _n=n):
                    if event == "call":
                        _n[0] += 1

                sys.setprofile(prof)
                ch.call_method("EchoService.Echo", cntl, req, pkg.Resp)
                sys.setprofile(None)
                assert not cntl.failed(), cntl.error_text
                counts.append(n[0])
            counts.sort()
            assert counts[len(counts) // 2] <= 60, counts
            ch.close()
        finally:
            server.stop()


class TestAppendPassThrough:
    def _run(self, pkg, body, n=1024):
        def echo(cntl, request, response, done):
            body(cntl, response)
            done()

        server = _server(pkg, 3, _service(pkg, "EchoService", echo),
                         usercode_inline=True)
        try:
            ch = _channel(pkg, 3, timeout_ms=10000, max_retry=0,
                          ici_local_device=3)
            cntl = pkg.rpc.Controller()
            cntl.request_attachment.append_device_array(pkg.payload(3, n))
            ch.call_method("EchoService.M", cntl, pkg.Req(message="a"),
                           pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            out = cntl.response_attachment.to_bytes()
            ch.close()
        finally:
            server.stop()
        return out

    def test_append_whole_view_adopts_handle(self, pkg):
        adopted = {}

        def body(cntl, response):
            response.message = "x"
            cntl.response_attachment.append(cntl.request_attachment)
            ra = cntl._peek_response_attachment()
            adopted["lazy"] = isinstance(ra, pkg.plane.NativeAttachment) \
                and not ra._mat and ra._h != 0
            adopted["donor_surrendered"] = cntl.request_attachment._h == 0

        out = self._run(pkg, body)
        assert out == bytes(_data(1024))
        assert adopted == {"lazy": True, "donor_surrendered": True}
        assert _drained(pkg)

    def test_append_then_more_bytes_materializes(self, pkg):
        def body(cntl, response):
            response.message = "x"
            cntl.response_attachment.append(cntl.request_attachment)
            cntl.response_attachment.append(b"tail")

        out = self._run(pkg, body, n=256)
        assert out == bytes(_data(256)) + b"tail"
        assert _drained(pkg)

    def test_append_into_nonempty_keeps_legacy_path(self, pkg):
        def body(cntl, response):
            response.message = "x"
            cntl.response_attachment.append(b"head")
            cntl.response_attachment.append(cntl.request_attachment)

        out = self._run(pkg, body, n=256)
        assert out == b"head" + bytes(_data(256))
        assert _drained(pkg)


# ---------------------------------------------------------------------
# the port's own: listeners apart, the plane's launches, the codec
# ---------------------------------------------------------------------

def test_two_cores_keep_their_listeners_apart():
    """A JAX server and a port server on ici://0 in one process are two
    listeners: each core sees only its own, and each channel reaches its
    own package's handler."""
    _PKGS["port"].activate()
    _PKGS["jax"].activate()
    jsrv = _server(_PKGS["jax"], 0)
    tsrv = None
    try:
        assert jnp_plane.has_listener(0)
        assert not tnp_plane.has_listener(0)
        tsrv = _server(_PKGS["port"], 0)
        assert tnp_plane.has_listener(0)
        assert jsrv._native_ici.requests() == 0
        for p, srv in ((_PKGS["jax"], jsrv), (_PKGS["port"], tsrv)):
            p.activate()
            ch = _channel(p, 0)
            cntl = p.rpc.Controller()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  p.Req(message=p.name), p.Resp)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == p.name
            assert srv._native_ici.requests() == 1
            ch.close()
    finally:
        jsrv.stop()
        if tsrv is not None:
            tsrv.stop()
    assert not jnp_plane.has_listener(0)
    assert not tnp_plane.has_listener(0)


def test_plane_launches_equal_relocations():
    """Every relocation at or above the threshold is one device-plane
    transfer (one p2p_copy), two per cross-rank echo; below it the
    relocation takes mesh.device_put and the plane stays idle."""
    p = _PKGS["port"]
    p.activate()
    server = _server(p, 2, usercode_inline=True)
    try:
        ch = _channel(p, 2)
        plane = tdp.plane()
        for n, crossings in ((4096, 2), (512, 0)):
            t0 = plane.stats()["transfers"]
            r0 = tnp_plane.relocation_stats()
            for i in range(5):
                cntl = trpc.Controller()
                cntl.request_attachment.append_device_array(
                    p.payload(1, n, seed=i + 1))
                ch.call_method("EchoService.Echo", cntl,
                               TReq(message="x"), TResp)
                assert not cntl.failed(), cntl.error_text
                assert cntl.response_attachment.to_bytes() == \
                    bytes(_data(n, seed=i + 1))
            r1 = tnp_plane.relocation_stats()
            assert plane.stats()["transfers"] - t0 == 5 * crossings
            assert r1["plane"] - r0["plane"] == 5 * crossings
            assert r1["device_put"] - r0["device_put"] == \
                (0 if crossings else 10)
        assert plane.active_transfers() == 0
        ch.close()
    finally:
        server.stop()
    assert _drained(p)


def test_refused_relocation_fails_the_call_with_its_text(monkeypatch):
    """A refused post fails the call with EINTERNAL (no library copy
    stands in, and it is no dead connection), and the plane's reason
    reaches the caller's error text."""
    p = _PKGS["port"]
    p.activate()
    server = _server(p, 2)
    try:
        ch = _channel(p, 2, max_retry=0)

        def refuse(*a, **k):
            raise tdp.DevicePlaneError("refused for the test")

        monkeypatch.setattr(tdp.DevicePlane, "post_send", refuse)
        cntl = trpc.Controller()
        cntl.request_attachment.append_device_array(p.payload(1))
        ch._native_ici_binding(cntl)
        ch._native_ici.call("EchoService.Echo", cntl, TReq(message="x"),
                            TResp)
        assert cntl.error_code_ == trpc.errors.EINTERNAL
        assert cntl.error_text == ("ici relocation failed: "
                                   "DevicePlaneError: refused for the test")
        ch.close()
    finally:
        server.stop()
    assert _drained(p)


@pytest.mark.parametrize("leg", ["request", "response"])
def test_refused_relocation_fails_call_method_without_a_python_try(
        monkeypatch, leg):
    """Through ``Channel.call_method`` (retries allowed), a refused
    relocation of the request or of the response fails the call with the
    plane's text: one post, no retry, no re-send on the Python plane, and
    the channel keeps its native binding, which serves the next call."""
    p = _PKGS["port"]
    p.activate()
    server = _server(p, 2)
    posts = []
    real = tdp.DevicePlane.post_send

    def refuse_one(self, arr, src, dst, mesh=None):
        posts.append((src, dst))
        # the request crosses rank 1 -> 2, the echoed answer 2 -> 3
        if (src, dst) == ((1, 2) if leg == "request" else (2, 3)):
            raise tdp.DevicePlaneError(f"refused {leg} for the test")
        return real(self, arr, src, dst, mesh=mesh)

    try:
        ch = _channel(p, 2, max_retry=3, ici_local_device=3)
        cntl = trpc.Controller()
        ch.call_method("EchoService.Echo", cntl, TReq(message="warm"),
                       TResp)
        assert not cntl.failed(), cntl.error_text
        binding = ch._native_ici
        assert binding is not None
        before = server._native_ici.requests()
        received = server.method_status("EchoService.Echo") \
            .received.get_value()
        monkeypatch.setattr(tdp.DevicePlane, "post_send", refuse_one)
        cntl = trpc.Controller()
        cntl.request_attachment.append_device_array(p.payload(1))
        ch.call_method("EchoService.Echo", cntl, TReq(message="x"), TResp)
        assert cntl.error_code_ == trpc.errors.EINTERNAL
        assert cntl.error_text == ("ici relocation failed: DevicePlaneError: "
                                   f"refused {leg} for the test")
        assert cntl.retried_count == 0
        assert posts == ([(1, 2)] if leg == "request"
                         else [(1, 2), (2, 3)])
        assert ch._native_ici is binding
        # the request reached the server only when its own leg passed,
        # and only through the native door
        served = 1 if leg == "response" else 0
        assert server._native_ici.requests() == before + served
        assert server.method_status("EchoService.Echo") \
            .received.get_value() == received + served
        monkeypatch.setattr(tdp.DevicePlane, "post_send", real)
        cntl = trpc.Controller()
        cntl.request_attachment.append_device_array(p.payload(1))
        resp = ch.call_method("EchoService.Echo", cntl, TReq(message="y"),
                              TResp)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "y"
        assert cntl.response_attachment.to_bytes() == bytes(_data(4096))
        assert server._native_ici.requests() == before + served + 1
        ch.close()
    finally:
        server.stop()
    assert _drained(p)


def _jax_request_frame(method: str, payload: bytes, timeout_ms: int):
    """The request frame the JAX core's TCP channel writes, read off a
    plain socket."""
    from brpc_tpu.rpc.native_fabric import NativeChannel
    lsock = pysock.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    got = {}

    def serve():
        conn, _ = lsock.accept()
        data = b""
        while len(data) < 12 or len(data) < 12 + int.from_bytes(
                data[4:8], "big") + int.from_bytes(data[8:12], "big"):
            chunk = conn.recv(65536)
            if not chunk:
                break
            data += chunk
        got["frame"] = data
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    ch = NativeChannel()
    ch.init(f"127.0.0.1:{port}")
    cntl = jrpc.Controller()
    cntl.timeout_ms = timeout_ms
    ch.call_method(method, cntl, JReq(message=payload.decode()), None)
    t.join(5)
    ch.close()
    lsock.close()
    return got["frame"]


def _port_pack(**kw):
    lib = tnative.load_or_raise()
    out = ctypes.c_void_p()
    body = kw.get("body", b"")
    n = lib.brpc_tpu_ici_codec_pack(
        kw.get("service"), kw.get("method"), kw.get("cid", 0),
        kw.get("log_id", 0), kw.get("timeout_ms", 0),
        kw.get("priority", 0), kw.get("tenant"), kw.get("deadline", 0),
        kw.get("err", 0), kw.get("err_text"), kw.get("retry_after", 0),
        kw.get("att_size", 0), body, len(body), ctypes.byref(out))
    frame = ctypes.string_at(out.value, n)
    lib.brpc_tpu_buf_free(out)
    return frame


def test_meta_codec_matches_python_protobuf_and_the_jax_core():
    """The port's C++ frames equal the JAX core's byte for byte (a request
    frame its TCP channel writes, a response frame its server writes),
    parse with python-protobuf, and a python-encoded meta carrying a field
    the C++ decoder skips still decodes."""
    from brpc_tpu.proto import rpc_meta_pb2 as meta_pb
    from brpc_tpu.rpc.native_fabric import NativeServer

    # request: the JAX core's bytes against the port's, same fields
    jframe = _jax_request_frame("EchoService.Echo", b"abc", 1500)
    msize = int.from_bytes(jframe[4:8], "big")
    meta = meta_pb.RpcMeta()
    meta.ParseFromString(jframe[12:12 + msize])
    body = jframe[12 + msize:]
    pframe = _port_pack(service=b"EchoService", method=b"Echo",
                        cid=meta.correlation_id,
                        timeout_ms=meta.request.timeout_ms,
                        att_size=meta.attachment_size, body=body)
    assert pframe == jframe

    # response: the JAX core's echo server answers a python-encoded
    # request whose meta carries stream_settings (skipped by the C++)
    server = NativeServer()

    class Echo(jrpc.Service):
        SERVICE_NAME = "EchoService"

        @jrpc.method(JReq, JResp)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

    server.add_service(Echo())
    port = server.start()
    s = pysock.create_connection(("127.0.0.1", port))
    try:
        req_meta = meta_pb.RpcMeta()
        req_meta.request.service_name = "EchoService"
        req_meta.request.method_name = "Echo"
        req_meta.correlation_id = 77
        req_meta.stream_settings.stream_id = 5
        req_meta.stream_settings.frame_type = 4
        rbody = JReq(message="skipfield").SerializeToString()
        mb = req_meta.SerializeToString()
        req_frame = (b"TRPC" + len(mb).to_bytes(4, "big")
                     + len(rbody).to_bytes(4, "big") + mb + rbody)
        s.sendall(req_frame)
        hdr = b""
        while len(hdr) < 12:
            hdr += s.recv(12 - len(hdr))
        msize = int.from_bytes(hdr[4:8], "big")
        bsize = int.from_bytes(hdr[8:12], "big")
        rest = b""
        while len(rest) < msize + bsize:
            rest += s.recv(msize + bsize - len(rest))
    finally:
        s.close()
        server.stop()
    jresp = hdr + rest
    rmeta = meta_pb.RpcMeta()
    rmeta.ParseFromString(rest[:msize])
    assert rmeta.correlation_id == 77 and rmeta.response.error_code == 0
    presp = _port_pack(cid=77, body=rest[msize:])
    assert presp == jresp

    # the port's decoder reads the python-encoded request, skipping the
    # stream settings, and every field of a full request meta
    lib = tnative.load_or_raise()
    fields = (ctypes.c_uint64 * 11)()
    names = ctypes.c_void_p()
    assert lib.brpc_tpu_ici_codec_unpack(req_frame, len(req_frame), fields,
                                         ctypes.byref(names)) == 0
    lib.brpc_tpu_buf_free(names)
    assert fields[2] == 77 and fields[10] == 1
    full = meta_pb.RpcMeta()
    full.request.service_name = "S"
    full.request.method_name = "M"
    full.request.log_id = 9
    full.request.timeout_ms = 250
    full.request.priority = 2
    full.request.tenant = "t"
    full.request.deadline_left_ms = 120
    full.correlation_id = 5
    full.attachment_size = 3
    ours = _port_pack(service=b"S", method=b"M", cid=5, log_id=9,
                      timeout_ms=250, priority=2, tenant=b"t", deadline=120,
                      att_size=3, body=b"xyz")
    fb = full.SerializeToString()
    assert ours == (b"TRPC" + len(fb).to_bytes(4, "big")
                    + (3).to_bytes(4, "big") + fb + b"xyz")
    err = meta_pb.RpcMeta()
    err.response.error_code = 2004
    err.response.error_text = "shed"
    err.response.retry_after_ms = 40
    err.correlation_id = 6
    eb = err.SerializeToString()
    assert _port_pack(cid=6, err=2004, err_text=b"shed",
                      retry_after=40) == (b"TRPC" + len(eb).to_bytes(4, "big")
                                          + (0).to_bytes(4, "big") + eb)


def test_loader_builds_into_the_package_and_never_under_native():
    """The port's core is built from its own sources into its _build/
    directory, keyed by their digest; the reference's native/ directory
    is never opened."""
    path = tnative.library_path()
    assert path.exists()
    assert path.parent == tnative.BUILD_DIR
    assert tnative.source_digest() in path.name
    assert "native/" not in str(path).replace(str(tnative.BUILD_DIR), "")
    for name in tnative.SOURCES:
        assert (tnative.CSRC / name).exists()


def test_async_calls_past_the_worker_cap_leave_workers_to_handlers():
    """More async native calls in flight than the scheduler's worker cap,
    against handlers that run on scheduler workers and answer only once
    every call has arrived: each parked call holds a caller thread, not a
    worker, so every handler runs and every call answers."""
    from brpc_tpu_torch.bthread.scheduler import TaskControl
    p = _PKGS["port"]
    p.activate()
    n = tflags.get_flag("bthread_max_concurrency") + 6
    arrived = []
    parked = []
    lock = threading.Lock()
    everyone = threading.Event()

    def hold(cntl, request, response, done):
        response.message = request.message
        with lock:
            arrived.append(1)
            parked.append(done)
            if len(arrived) == n:
                everyone.set()

    server = _server(p, 4, _service(p, "Hold", hold))
    ch = _channel(p, 4, timeout_ms=20000, max_retry=0)
    answered = []
    finished = threading.Event()

    def on_done(c):
        with lock:
            answered.append((c.error_code_, c.response.message
                             if c.response is not None else None))
            if len(answered) == n:
                finished.set()

    try:
        for i in range(n):
            ch.call_method("Hold.M", trpc.Controller(),
                           TReq(message=str(i)), TResp, done=on_done)
        assert everyone.wait(15), f"{len(arrived)} of {n} handlers ran"
        for d in parked:
            d()
        assert finished.wait(15)
        assert sorted(m for _, m in answered) == sorted(
            str(i) for i in range(n))
        assert all(code == 0 for code, _ in answered)
        assert TaskControl.instance()._blocked_workers == 0
        ch.close()
    finally:
        server.stop()


def test_async_caller_threads_exit_after_a_burst(monkeypatch):
    """The threads that carry async native calls grow with a burst of
    parked calls and, idle past their timeout, exit again."""
    p = _PKGS["port"]
    p.activate()
    callers = tnp_plane._callers
    monkeypatch.setattr(callers, "idle_s", 0.2)
    n = 24
    parked = []
    lock = threading.Lock()
    everyone = threading.Event()

    def hold(cntl, request, response, done):
        response.message = request.message
        with lock:
            parked.append(done)
            if len(parked) == n:
                everyone.set()

    server = _server(p, 5, _service(p, "Hold", hold))
    ch = _channel(p, 5, timeout_ms=20000, max_retry=0)
    answered = []
    finished = threading.Event()

    def on_done(c):
        with lock:
            answered.append(c.error_code_)
            if len(answered) == n:
                finished.set()

    try:
        for i in range(n):
            ch.call_method("Hold.M", trpc.Controller(),
                           TReq(message=str(i)), TResp, done=on_done)
        assert everyone.wait(15), f"{len(parked)} of {n} handlers ran"
        peak = callers.threads()
        assert peak >= n
        for d in parked:
            d()
        assert finished.wait(15)
        assert answered == [0] * n
        deadline = time.monotonic() + 5
        while callers.threads() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert callers.threads() == 0
        assert not [t for t in threading.enumerate()
                    if t.name == "ici_native_caller"]
        # the pool starts again for the next call
        cntl = trpc.Controller()
        done = threading.Event()
        ch.call_method("Hold.M", cntl, TReq(message="again"), TResp,
                       done=lambda c: done.set())
        deadline = time.monotonic() + 5
        while len(parked) <= n and time.monotonic() < deadline:
            time.sleep(0.01)
        parked[-1]()
        assert done.wait(10) and not cntl.failed()
        ch.close()
    finally:
        server.stop()


_BUSY_POLLER_AT_EXIT = """
import sys, time, torch
from brpc_tpu_torch.bthread.device_waiter import DeviceEventDispatcher

a = torch.randn(400, 400)


class BusyEvent:
    # stands in for a CUDA event: its synchronize is a torch call that
    # releases the GIL, as Event.synchronize does
    def synchronize(self):
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.3:
            torch.mm(a, a)


done = []
for i in range(4):
    DeviceEventDispatcher.instance().on_event(
        BusyEvent(), "cuda:0", lambda i=i: done.append(i))
time.sleep(0.1)
print("exiting", flush=True)
sys.exit(3)
"""


def test_exit_with_a_busy_poller_does_not_abort():
    """A process that exits while the device poller waits inside a torch
    call leaves with its own exit code after the poller drained: the
    runtime does not end the poller inside torch's C++ frames, which
    aborts (SIGABRT, "terminate called without an active exception")."""
    import subprocess
    r = subprocess.run([sys.executable, "-c", _BUSY_POLLER_AT_EXIT],
                       capture_output=True, text=True, timeout=60,
                       cwd=str(tnative.CSRC.parent.parent))
    assert r.returncode == 3, (r.returncode, r.stderr[-2000:])
    assert "terminate called" not in r.stderr
    assert r.stdout.strip() == "exiting"
