"""The mem:// loopback plane on both packages (``brpc_tpu.rpc.loopback``
and ``brpc_tpu_torch.rpc.loopback``): admission, cancel, timeout, drain
and isolation, held to the same codes and counts, and the server-side
Controller pool driven through real servers on both in-process planes
(``tests/test_controller_pool.py::TestPoolThroughServers``).
"""
from __future__ import annotations

import gc
import threading
import time
import types

import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import ici as jici
from brpc_tpu import rpc as jrpc
from brpc_tpu.rpc import loopback as jloop
from brpc_tpu.rpc.admission import AdmissionOptions as JAdm
from brpc_tpu.rpc.controller import server_controller_pool as jpool
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.ici import device_plane as tdp
from brpc_tpu_torch.ici.mesh import IciMesh as TMesh
from brpc_tpu_torch.proto.echo_pb2 import (EchoRequest as TReq,
                                           EchoResponse as TResp)
from brpc_tpu_torch.rpc import loopback as tloop
from brpc_tpu_torch.rpc.admission import AdmissionOptions as TAdm
from brpc_tpu_torch.rpc.controller import server_controller_pool as tpool
from tests.echo_pb2 import EchoRequest as JReq, EchoResponse as JResp

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, loop=jloop, Adm=JAdm,
                            pool=jpool, Req=JReq, Resp=JResp)
PORT = types.SimpleNamespace(name="port", rpc=trpc, loop=tloop, Adm=TAdm,
                             pool=tpool, Req=TReq, Resp=TResp)

_seq = [0]


def unique(tag):
    _seq[0] += 1
    return f"mem://lb-{tag}-{_seq[0]}"


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return JAX if request.param == "jax" else PORT


@pytest.fixture(scope="module", autouse=True)
def _drain_pools():
    yield
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and (
            list_sockets() or tpool.live() or tloop._inflight):
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()
    assert tpool.live() == 0
    assert not tloop._inflight


def _server(pkg, target, svc, **opts):
    o = pkg.rpc.ServerOptions()
    for k, v in opts.items():
        setattr(o, k, v)
    server = pkg.rpc.Server(o)
    server.add_service(svc)
    assert server.start(target) == 0
    return server


def _channel(pkg, target, **opts):
    ch = pkg.rpc.Channel()
    ch.init(target, options=pkg.rpc.ChannelOptions(**opts))
    return ch


def _service(pkg, fn, name="Echo"):
    svc_cls = type(name, (pkg.rpc.Service,), {"SERVICE_NAME": name})
    method = pkg.rpc.method(pkg.Req, pkg.Resp)(
        lambda self, cntl, request, response, done:
        fn(cntl, request, response, done))
    method.__name__ = "Echo"
    setattr(svc_cls, "Echo", method)
    return svc_cls()


# ---------------------------------------------------------------------
# admission (test_admission.py TestPlaneShedSemantics, both packages)
# ---------------------------------------------------------------------

def _overloadable(pkg, target, rate=50.0, queue_ms=2000.0):
    gate = threading.Event()
    entered = []

    def echo(cntl, request, response, done):
        if request.message == "block":
            entered.append(1)
            gate.wait(10)
        response.message = f"{cntl.priority}/{cntl.tenant}"
        done()

    server = _server(pkg, target, _service(pkg, echo), max_concurrency=2,
                     admission=pkg.Adm(max_queue_ms=queue_ms,
                                       service_rate_override=rate))
    return server, gate, entered


def _saturate(pkg, ch, entered, n=2):
    threads = []
    for _ in range(n):
        def blocker():
            c = pkg.rpc.Controller()
            c.priority = 0
            ch.call_method("Echo.Echo", c, pkg.Req(message="block"),
                           pkg.Resp)
        t = threading.Thread(target=blocker)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + 5
    while len(entered) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(entered) == n, "server slots did not fill"
    return threads


def _drive_shed(pkg, server, gate, entered, target):
    ch = _channel(pkg, target, timeout_ms=4000, max_retry=0)
    threads = []
    try:
        threads = _saturate(pkg, ch, entered)
        c = pkg.rpc.Controller()
        c.priority = 3
        c.tenant = "bulk"
        r = ch.call_method("Echo.Echo", c, pkg.Req(message="x"), pkg.Resp)
        assert r is None and c.error_code_ == pkg.rpc.errors.ELIMIT
        assert c.retry_after_ms > 0 and "shed" in c.error_text_
        res = {}

        def hp():
            c2 = pkg.rpc.Controller()
            c2.priority = 0
            c2.tenant = "svc"
            r2 = ch.call_method("Echo.Echo", c2, pkg.Req(message="hi"),
                                pkg.Resp)
            res["code"] = c2.error_code_
            res["msg"] = r2.message if r2 else c2.error_text_

        t = threading.Thread(target=hp)
        t.start()
        deadline = time.monotonic() + 3
        while server.admission.queued() != 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.admission.queued() == 1
        gate.set()
        t.join(5)
        assert res == {"code": 0, "msg": "0/svc"}
        d = server.admission.describe()
        assert d["by_tenant_band"].get("shed_band[bulk][b3]") == 1
        assert d["by_tenant_band"].get("admitted[svc][b0]") == 1
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()


def test_loopback_plane_shed_semantics(pkg):
    target = unique("adm")
    server, gate, entered = _overloadable(pkg, target)
    try:
        _drive_shed(pkg, server, gate, entered, target)
        assert server.connections() == []     # loopback really engaged
    finally:
        server.stop()


def test_native_ici_plane_shed_semantics(pkg):
    """The native door's admission: the same decision, codes and
    counters as the loopback and wire planes."""
    if pkg is JAX:
        import jax
        jici.IciMesh.set_default(jici.IciMesh(jax.devices()))
    else:
        TMesh.set_default(TMesh(ranks=8, device="cpu"))
    try:
        server, gate, entered = _overloadable(pkg, "ici://7")
        try:
            assert server._native_ici is not None
            _drive_shed(pkg, server, gate, entered, "ici://7")
            assert server.connections() == []  # no Python-plane socket
        finally:
            server.stop()
    finally:
        if pkg is PORT:
            TMesh.set_default(None)


def test_draining_bounces_queued_entries_with_elogoff(pkg):
    target = unique("drain")
    server, gate, entered = _overloadable(pkg, target)
    ch = _channel(pkg, target, timeout_ms=4000, max_retry=0)
    threads = []
    try:
        threads = _saturate(pkg, ch, entered)
        res = {}

        def hp():
            c2 = pkg.rpc.Controller()
            c2.priority = 0
            ch.call_method("Echo.Echo", c2, pkg.Req(message="hi"),
                           pkg.Resp)
            res["code"] = c2.error_code_

        t = threading.Thread(target=hp)
        t.start()
        deadline = time.monotonic() + 3
        while server.admission.queued() != 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.admission.queued() == 1
        stopper = threading.Thread(target=lambda: server.stop(3.0))
        stopper.start()
        t.join(5)
        assert res["code"] == pkg.rpc.errors.ELOGOFF
        gate.set()
        stopper.join(5)
        assert not stopper.is_alive()
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()


def test_gates_without_admission(pkg):
    """max_concurrency and a method limiter reject with ELIMIT; an unknown
    method is ENOMETHOD and an unknown service ENOSERVICE; the status
    counters read the same on both packages."""
    gate = threading.Event()
    entered = []

    def echo(cntl, request, response, done):
        if request.message == "block":
            entered.append(1)
            gate.wait(10)
        response.message = request.message
        done()

    target = unique("gates")
    server = _server(pkg, target, _service(pkg, echo), max_concurrency=1)
    ch = _channel(pkg, target, timeout_ms=4000, max_retry=0)
    t = threading.Thread(target=lambda: ch.call_method(
        "Echo.Echo", pkg.rpc.Controller(), pkg.Req(message="block"),
        pkg.Resp))
    try:
        t.start()
        deadline = time.monotonic() + 5
        while not entered and time.monotonic() < deadline:
            time.sleep(0.01)
        c = pkg.rpc.Controller()
        ch.call_method("Echo.Echo", c, pkg.Req(message="x"), pkg.Resp)
        assert c.error_code_ == pkg.rpc.errors.ELIMIT
        gate.set()
        t.join(5)
        codes = []
        for method in ("Echo.Nope", "Nope.Echo"):
            c = pkg.rpc.Controller()
            ch.call_method(method, c, pkg.Req(message="x"), pkg.Resp)
            codes.append(c.error_code_)
        assert codes == [pkg.rpc.errors.ENOMETHOD, pkg.rpc.errors.ENOSERVICE]
        st = server.method_status("Echo.Echo")
        assert st.concurrency == 0
        assert server.inflight_requests() == 0
        assert server.connections() == []
    finally:
        gate.set()
        t.join(5)
        ch.close()
        server.stop()

    target = unique("limit")
    gate.clear()
    entered.clear()
    server = _server(pkg, target, _service(pkg, echo),
                     method_max_concurrency={"Echo.Echo": 1})
    ch = _channel(pkg, target, timeout_ms=4000, max_retry=0)
    t = threading.Thread(target=lambda: ch.call_method(
        "Echo.Echo", pkg.rpc.Controller(), pkg.Req(message="block"),
        pkg.Resp))
    try:
        t.start()
        deadline = time.monotonic() + 5
        while not entered and time.monotonic() < deadline:
            time.sleep(0.01)
        c = pkg.rpc.Controller()
        ch.call_method("Echo.Echo", c, pkg.Req(message="x"), pkg.Resp)
        assert c.error_code_ == pkg.rpc.errors.ELIMIT
        assert "max_concurrency" in c.error_text_
    finally:
        gate.set()
        t.join(5)
        ch.close()
        server.stop()
    assert server.inflight_requests() == 0


# ---------------------------------------------------------------------
# the failure surface: cancel, timeout, stop
# ---------------------------------------------------------------------

def _slow_server(pkg, target, delay_s, done_evt, **opts):
    def echo(cntl, request, response, done):
        time.sleep(delay_s)
        response.message = "late"
        cntl.response_attachment.append(b"late-bytes")
        done()
        done_evt.set()

    return _server(pkg, target, _service(pkg, echo), **opts)


def test_cancel_claims_the_call_and_drops_the_late_answer(pkg):
    target = unique("cancel")
    handled = threading.Event()
    server = _slow_server(pkg, target, 0.3, handled)
    ch = _channel(pkg, target, timeout_ms=5000, max_retry=0)
    try:
        ended = threading.Event()
        cntl = pkg.rpc.Controller()
        ch.call_method("Echo.Echo", cntl, pkg.Req(message="c"), pkg.Resp,
                       lambda c: ended.set())
        time.sleep(0.05)
        cntl.cancel()
        assert ended.wait(5)
        assert cntl.error_code_ == pkg.rpc.errors.ECANCELED
        assert handled.wait(5)
        time.sleep(0.05)
        assert cntl.error_code_ == pkg.rpc.errors.ECANCELED
        assert cntl.response is None
        assert cntl._peek_response_attachment() is None
        cntl.join(1)                      # a finished call joins at once
        assert server.connections() == []
    finally:
        ch.close()
        server.stop()
        server.join(5)
    assert server.inflight_requests() == 0


@pytest.mark.parametrize("inline", [False, True])
def test_timeout_is_the_callers_deadline(pkg, inline):
    """ERPCTIMEDOUT at the caller's deadline; the handler runs on and its
    late completion is dropped.  (Inline, the handler runs on the
    caller's thread, so the claim comes after it returns.)"""
    target = unique("tmo")
    handled = threading.Event()
    server = _slow_server(pkg, target, 0.3, handled, usercode_inline=inline)
    ch = _channel(pkg, target, timeout_ms=100, max_retry=0)
    try:
        cntl = pkg.rpc.Controller()
        t0 = time.monotonic()
        r = ch.call_method("Echo.Echo", cntl, pkg.Req(message="t"),
                           pkg.Resp)
        dt = time.monotonic() - t0
        if inline:
            # the completion ran first: the call answered, late
            assert cntl.error_code_ == 0 and dt >= 0.3
            assert r.message == "late"
        else:
            assert r is None
            assert cntl.error_code_ == pkg.rpc.errors.ERPCTIMEDOUT
            assert dt < 0.3, dt
            assert handled.wait(5)
            time.sleep(0.05)
            assert cntl.error_code_ == pkg.rpc.errors.ERPCTIMEDOUT
            assert cntl._peek_response_attachment() is None
    finally:
        ch.close()
        server.stop()
        server.join(5)


def test_async_timeout_fires_done_once(pkg):
    target = unique("atmo")
    handled = threading.Event()
    server = _slow_server(pkg, target, 0.3, handled)
    ch = _channel(pkg, target, timeout_ms=80, max_retry=0)
    try:
        calls = []
        ended = threading.Event()

        def done(c):
            calls.append(c.error_code_)
            ended.set()

        cntl = pkg.rpc.Controller()
        ch.call_method("Echo.Echo", cntl, pkg.Req(message="a"), pkg.Resp,
                       done)
        assert ended.wait(5)
        assert handled.wait(5)
        time.sleep(0.1)
        assert calls == [pkg.rpc.errors.ERPCTIMEDOUT]
    finally:
        ch.close()
        server.stop()
        server.join(5)


def test_stop_past_grace_fails_stragglers_elogoff(pkg):
    target = unique("strag")
    handled = threading.Event()
    server = _slow_server(pkg, target, 1.0, handled)
    ch = _channel(pkg, target, timeout_ms=8000, max_retry=0)
    try:
        out = {}
        ended = threading.Event()

        def done(c):
            out["code"] = c.error_code_
            ended.set()

        ch.call_method("Echo.Echo", pkg.rpc.Controller(),
                       pkg.Req(message="s"), pkg.Resp, done)
        time.sleep(0.1)
        t0 = time.monotonic()
        server.stop(0.3)
        assert 0.25 <= time.monotonic() - t0 < 1.0
        assert ended.wait(5)
        assert out["code"] == pkg.rpc.errors.ELOGOFF
        server.join(5)
        assert handled.is_set()
        assert server.inflight_requests() == 0
    finally:
        ch.close()
        server.stop()


def test_new_call_while_draining_bounces_elogoff(pkg):
    target = unique("lame")
    handled = threading.Event()
    server = _slow_server(pkg, target, 0.4, handled)
    ch = _channel(pkg, target, timeout_ms=5000, max_retry=0)
    try:
        slow = {}
        ended = threading.Event()
        ch.call_method("Echo.Echo", pkg.rpc.Controller(),
                       pkg.Req(message="s"), pkg.Resp,
                       lambda c: (slow.setdefault("code", c.error_code_),
                                  ended.set()))
        time.sleep(0.05)
        stopper = threading.Thread(target=lambda: server.stop(3.0))
        stopper.start()
        deadline = time.monotonic() + 2
        while not server.is_draining() and time.monotonic() < deadline:
            time.sleep(0.005)
        c = pkg.rpc.Controller()
        ch.call_method("Echo.Echo", c, pkg.Req(message="new"), pkg.Resp)
        assert c.error_code_ == pkg.rpc.errors.ELOGOFF
        assert ended.wait(5) and slow["code"] == 0
        stopper.join(5)
    finally:
        ch.close()
        server.stop()


# ---------------------------------------------------------------------
# isolation and zero copy
# ---------------------------------------------------------------------

def test_handler_gets_its_own_controller_and_request(pkg):
    seen = {}

    def echo(cntl, request, response, done):
        seen["cntl"] = cntl
        request.message = "mutated"
        cntl.set_failed(0, "")
        response.message = "ok"
        done()

    target = unique("iso")
    server = _server(pkg, target, _service(pkg, echo))
    ch = _channel(pkg, target, timeout_ms=5000, max_retry=0)
    try:
        cntl = pkg.rpc.Controller()
        cntl.log_id = 17
        req = pkg.Req(message="mine")
        resp = ch.call_method("Echo.Echo", cntl, req, pkg.Resp)
        assert resp.message == "ok" and not cntl.failed()
        assert req.message == "mine"
        assert seen["cntl"] is not cntl
        assert server.connections() == []
    finally:
        ch.close()
        server.stop()


def test_attachment_crosses_by_reference(pkg):
    """The handler sees the caller's attachment buffer; a DEVICE block
    crosses without a copy (no plane transfer on the port)."""
    seen = {}

    def echo(cntl, request, response, done):
        att = cntl.request_attachment
        seen["data"] = att.backing_block(0).block.data
        response.message = "ok"
        cntl.response_attachment.append(att)
        done()

    if pkg is JAX:
        import jax
        import jax.numpy as jnp
        arr = jax.device_put(jnp.arange(4096, dtype=jnp.uint8))
    else:
        arr = torch.arange(4096).to(torch.uint8)
    target = unique("zc")
    server = _server(pkg, target, _service(pkg, echo))
    ch = _channel(pkg, target, timeout_ms=5000, max_retry=0)
    try:
        t0 = tdp.plane().stats()["transfers"]
        cntl = pkg.rpc.Controller()
        cntl.request_attachment.append_device_array(arr)
        ch.call_method("Echo.Echo", cntl, pkg.Req(message="x"), pkg.Resp)
        assert not cntl.failed(), cntl.error_text
        assert seen["data"] is arr
        assert cntl.response_attachment.backing_block(0).block.data is arr
        assert tdp.plane().stats()["transfers"] == t0
    finally:
        ch.close()
        server.stop()


def test_port_counts_its_loopback_calls_and_screens():
    """The port counts the calls its loopback plane served; hedging on the
    channel, an active fault injector, the flag off and an isolated
    method take the wire path instead."""
    def echo(cntl, request, response, done):
        response.message = request.message
        done()

    target = unique("screen")
    server = _server(PORT, target, _service(PORT, echo))
    try:
        n0 = tloop.calls
        ch = _channel(PORT, target, timeout_ms=5000, max_retry=0)
        for i in range(3):
            c = trpc.Controller()
            assert ch.call_method("Echo.Echo", c, TReq(message=str(i)),
                                  TResp).message == str(i)
        assert tloop.calls - n0 == 3 and server.connections() == []
        hedged = _channel(PORT, target, timeout_ms=5000, max_retry=0,
                          backup_request_ms=500)
        c = trpc.Controller()
        assert hedged.call_method("Echo.Echo", c, TReq(message="h"),
                                  TResp).message == "h"
        assert tloop.calls - n0 == 3
        with trpc.fault_injection.inject(
                trpc.fault_injection.FaultInjector()):
            c = trpc.Controller()
            ch.call_method("Echo.Echo", c, TReq(message="f"), TResp)
            assert not c.failed()
        old = tflags.get_flag("mem_loopback_fast")
        tflags.set_flag("mem_loopback_fast", False)
        try:
            c = trpc.Controller()
            ch.call_method("Echo.Echo", c, TReq(message="w"), TResp)
            assert not c.failed()
        finally:
            tflags.set_flag("mem_loopback_fast", old)
        assert tloop.calls - n0 == 3
        assert len(server.connections()) >= 1
        ch.close()
        hedged.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------
# the server Controller pool through real servers (TestPoolThroughServers)
# ---------------------------------------------------------------------

def _stain_service(pkg):
    def echo(cntl, request, response, done):
        if request.message == "stain":
            cntl.response_attachment.append(b"stain" * 100)
            cntl.log_id = 999
            cntl.set_failed(1003, "stained")
            done()
            return
        assert cntl.error_code_ == 0, "stale error code leaked"
        assert cntl.log_id == 0, "stale log_id leaked"
        resp_att = cntl._peek_response_attachment()
        assert resp_att is None or len(resp_att) == 0, \
            "stale response attachment leaked"
        response.message = request.message
        done()

    return _service(pkg, echo, name="EchoService")


def _drive_reuse(pkg, target, n_pairs=40):
    ch = _channel(pkg, target, timeout_ms=10000, max_retry=0)
    for i in range(n_pairs):
        c1 = pkg.rpc.Controller()
        ch.call_method("EchoService.Echo", c1, pkg.Req(message="stain"),
                       pkg.Resp)
        assert c1.error_code_ == 1003, (c1.error_code_, c1.error_text_)
        c2 = pkg.rpc.Controller()
        r = ch.call_method("EchoService.Echo", c2,
                           pkg.Req(message=f"clean{i}"), pkg.Resp)
        assert not c2.failed(), (c2.error_code_, c2.error_text_)
        assert r.message == f"clean{i}"
    ch.close()


class TestPoolThroughServers:
    def test_reuse_clean_over_mem_loopback(self, pkg):
        target = unique("cpool")
        server = _server(pkg, target, _stain_service(pkg))
        try:
            live0 = pkg.pool.live()
            _drive_reuse(pkg, target)
            assert pkg.pool.live() == live0
        finally:
            server.stop()

    def test_reuse_clean_over_native_ici(self, pkg):
        if pkg is JAX:
            import jax
            jici.IciMesh.set_default(jici.IciMesh(jax.devices()))
        else:
            TMesh.set_default(TMesh(ranks=8, device="cpu"))
        server = _server(pkg, "ici://7", _stain_service(pkg),
                         usercode_inline=True)
        try:
            assert server._native_ici is not None
            live0 = pkg.pool.live()
            _drive_reuse(pkg, "ici://7")
            assert pkg.pool.live() == live0
            assert server._native_ici.requests() == 80
        finally:
            server.stop()
            if pkg is PORT:
                TMesh.set_default(None)

    def test_pool_reaches_steady_state_under_sustained_load(self, pkg):
        def echo(cntl, request, response, done):
            response.message = request.message
            done()

        target = unique("steady")
        server = _server(pkg, target, _service(pkg, echo,
                                               name="EchoService"))
        try:
            ch = _channel(pkg, target, timeout_ms=10000, max_retry=0)

            def worker(k):
                for i in range(30):
                    c = pkg.rpc.Controller()
                    ch.call_method("EchoService.Echo", c,
                                   pkg.Req(message=f"w{k}-{i}"), pkg.Resp)
                    assert not c.failed(), c.error_text

            for _round in range(2):
                ts = [threading.Thread(target=worker, args=(k,))
                      for k in range(8)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                if _round == 0:
                    mark = pkg.pool.free_count()
            assert pkg.pool.free_count() <= max(mark, 1)
            ch.close()
        finally:
            server.stop()
