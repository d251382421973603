"""The port's lame-duck lifecycle, held against the JAX package on the CPU.

Mirrors the in-process cases of the JAX package's
``tests/test_server_lifecycle.py``, over ``mem://`` and over ``ici://`` on a
CPU mesh with the device plane engaged:

  * ``stop(grace_s)`` flips the server to draining: new requests bounce
    with retryable ELOGOFF, in-flight handlers complete inside the window,
    and ``stop`` returns as soon as the drain converges; a handler past
    the window fails ELOGOFF.  The same script on the JAX package's
    server gives the same outcomes.
  * A request queued on the usercode backup pool holds the drain gate.
  * GOODBYE pulls the endpoint from every live balancer before the first
    health-check probe; a restart on the endpoint is revived by the
    checker's probe, run here directly (``probe_now``) rather than by
    waiting out its timer.
  * The drain gate waits for a posted device-plane transfer, and a grace
    expiry fails an unmatched send, releasing its source pin.
  * Hygiene: stop/start cycles leak no thread, ``join`` waits for
    in-flight handlers, a stop from inside the drain returns while a
    second concurrent stop waits, and the SIGTERM hook drains a server
    in a process of its own.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.rpc import lameduck as jlameduck
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy.load_balancers import LocalityAwareLB
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors, health_check, lameduck
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import EchoRequest as JEchoRequest
from tests.echo_pb2 import EchoResponse as JEchoResponse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold", "health_check_interval_s")


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server and channel here is closed by its test; at teardown
    the port's sockets, pooled server Controllers and plane pins are all
    returned, and no health check is left probing."""
    yield
    deadline = time.monotonic() + 2.0
    plane = dp.DevicePlane._instance
    while (rpc.list_sockets() or server_controller_pool.live()
           or (plane is not None and plane.active_transfers())) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0
    assert plane is None or plane.active_transfers() == 0
    for ep in list(health_check._tasks):
        health_check._tasks[ep].cancel()
        lameduck.clear_peer_draining(ep)


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


_EPS = iter(range(10_000))


@pytest.fixture(params=["mem", "ici"])
def addr(request):
    """A fresh endpoint on the plane: ``mem://`` or an ici rank of the
    CPU mesh (ranks 2-7; the clients' payloads are owned by rank 1)."""
    if request.param == "mem":
        return f"mem://life-{next(_EPS)}"
    request.getfixturevalue("mesh")
    return f"ici://{2 + next(_EPS) % 6}"


def _echo_service(tag="srv", slow_messages=(), slow_s=0.0, finished=None,
                  pkg=rpc, req=EchoRequest, resp=EchoResponse):
    class Echo(pkg.Service):
        SERVICE_NAME = "EchoService"

        @pkg.method(req, resp)
        def Echo(self, cntl, request, response, done):
            if request.message in slow_messages:
                time.sleep(slow_s)
                if finished is not None:
                    finished.set()
            response.message = f"{tag}:{request.message}"
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    return Echo()


def _channel(target, timeout_ms=5000, max_retry=0, pkg=rpc):
    ch = pkg.Channel()
    ch.init(target, options=pkg.ChannelOptions(timeout_ms=timeout_ms,
                                               max_retry=max_retry))
    return ch


def _call(ch, msg, att=0):
    cntl = rpc.Controller()
    if att:
        mesh = IciMesh.default()
        cntl.request_attachment.append_device_array(
            mesh.own(torch.full((att,), 3, dtype=torch.uint8), 1))
    r = ch.call_method("EchoService.Echo", cntl, EchoRequest(message=msg),
                       EchoResponse)
    return cntl, r


def _async(ch, msg, out, att=0, pkg=rpc, req=EchoRequest, resp=EchoResponse):
    evt = threading.Event()
    cntl = pkg.Controller()
    if att:
        mesh = IciMesh.default()
        cntl.request_attachment.append_device_array(
            mesh.own(torch.full((att,), 5, dtype=torch.uint8), 1))

    def done(c):
        out[msg] = (c.error_code_, getattr(c.response, "message", None),
                    len(c.response_attachment) if not c.failed() else 0)
        evt.set()
    ch.call_method("EchoService.Echo", cntl, req(message=msg), resp,
                   done=done)
    return evt


def _wait(cond, timeout=3.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def _att_bytes(addr):
    return 8192 if addr.startswith("ici://") else 0


# ---- drain -------------------------------------------------------------

def test_drain_completes_inflight_and_rejects_new_with_elogoff(addr):
    finished = threading.Event()
    server = rpc.Server()
    server.add_service(_echo_service(slow_messages=("slow",), slow_s=0.5,
                                     finished=finished))
    assert server.start(addr) == 0
    ch = _channel(addr)
    att = _att_bytes(addr)
    out = {}
    try:
        evt = _async(ch, "slow", out, att=att)
        time.sleep(0.1)
        stop_dt = {}

        def stopper():
            t0 = time.monotonic()
            server.stop(5.0)
            stop_dt["dt"] = time.monotonic() - t0

        t = threading.Thread(target=stopper)
        t.start()
        assert _wait(server.is_draining)
        # a new request (on the open connection, or a reconnect after
        # the GOODBYE): retryable ELOGOFF
        c2, _ = _call(ch, "new", att=att)
        assert c2.error_code_ == errors.ELOGOFF, (c2.error_code_,
                                                  c2.error_text_)
        t.join(10)
        assert finished.is_set() and evt.wait(5)
        assert out["slow"] == (0, "srv:slow", att)
        assert stop_dt["dt"] < 3.0, stop_dt
        assert not server.is_running() and not server.is_draining()
        assert server.inflight_requests() == 0
        assert not lameduck.local_draining()
        plane = dp.DevicePlane._instance
        assert plane is None or plane.active_transfers() == 0
    finally:
        ch.close()
        server.stop()


def test_post_grace_straggler_fails_elogoff(addr):
    finished = threading.Event()
    # the ici leg is the Python plane's: its stop fails the connections
    # with ELOGOFF (the native door fails a straggler with the dead-peer
    # code, as the reference's does: test_torch_native_ici.py)
    server = rpc.Server(rpc.ServerOptions(native_ici=False))
    server.add_service(_echo_service(slow_messages=("veryslow",),
                                     slow_s=1.0, finished=finished))
    assert server.start(addr) == 0
    ch = _channel(addr, timeout_ms=8000)
    out = {}
    try:
        evt = _async(ch, "veryslow", out, att=_att_bytes(addr))
        time.sleep(0.1)
        t0 = time.monotonic()
        server.stop(0.3)
        dt = time.monotonic() - t0
        assert 0.25 <= dt < 1.0, dt
        assert evt.wait(5), "straggler call never completed"
        assert out["veryslow"][0] == errors.ELOGOFF, out
        server.join(5.0)
        assert finished.is_set()
        assert server.inflight_requests() == 0
    finally:
        ch.close()
        server.stop()


def _drain_script(pkg, addr, req, resp):
    """slow in-flight call, stop(1.0) in a thread, a new call during the
    drain, then a straggler past a 0.2 s window on a restart: the codes
    each call ends with."""
    finished = threading.Event()
    server = pkg.Server()
    server.add_service(_echo_service(
        slow_messages=("slow", "veryslow"), slow_s=0.4, finished=finished,
        pkg=pkg, req=req, resp=resp))
    assert server.start(addr) == 0
    ch = _channel(addr, pkg=pkg)
    out = {}
    try:
        evt = _async(ch, "slow", out, pkg=pkg, req=req, resp=resp)
        time.sleep(0.1)
        t = threading.Thread(target=lambda: server.stop(1.0))
        t.start()
        assert _wait(server.is_draining)
        evt_new = _async(ch, "new", out, pkg=pkg, req=req, resp=resp)
        assert evt.wait(5) and evt_new.wait(5)
        t.join(5)
        # drop the stopped run's connection before the restart: a call
        # must not race its EOF
        ch.close()
        assert server.start(addr) == 0
        ch2 = _channel(addr, pkg=pkg)
        evt_late = _async(ch2, "veryslow", out, pkg=pkg, req=req, resp=resp)
        time.sleep(0.1)
        server.stop(0.1)
        assert evt_late.wait(5)
        ch2.close()
        server.join(5.0)
    finally:
        ch.close()
        server.stop()
    return {k: v[:2] for k, v in out.items()}


def test_drain_outcomes_agree_with_the_jax_server():
    want = {"slow": (0, "srv:slow"), "new": (errors.ELOGOFF, None),
            "veryslow": (errors.ELOGOFF, None)}
    got_port = _drain_script(rpc, "mem://life-parity", EchoRequest,
                             EchoResponse)
    got_jax = _drain_script(jrpc, "mem://life-parity-jax", JEchoRequest,
                            JEchoResponse)
    assert got_port == got_jax == want


def test_drain_waits_for_usercode_pool_backlog(addr):
    """A request QUEUED on the backup pool (not yet admitted) holds the
    drain gate: the started one completes, the queued one is answered
    with retryable ELOGOFF, and the stop waits for both."""
    release = threading.Event()
    entered = threading.Event()
    done_msgs = []

    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            entered.set()
            release.wait(5)
            done_msgs.append(request.message)
            response.message = "srv:" + request.message
            done()

    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          usercode_backup_threads=1))
    server.add_service(Echo())
    assert server.start(addr) == 0
    ch = _channel(addr, timeout_ms=8000)
    out = {}
    try:
        # m1 goes out once m0 reached the pool: an async call on the
        # native plane is issued from a caller thread of its own, so two
        # issued back to back may arrive in either order
        evts = [_async(ch, "m0", out)]
        assert _wait(lambda: server._usercode_queued >= 1, 2.0)
        evts.append(_async(ch, "m1", out))
        assert _wait(lambda: server._usercode_queued >= 2, 2.0)
        # the one backup thread runs m0's handler before the drain starts
        # (under load it may not have picked m0 up yet)
        assert entered.wait(5)
        assert done_msgs == [] and server.inflight_requests() == 2
        threading.Timer(0.3, release.set).start()
        server.stop(5.0)
        for evt in evts:
            assert evt.wait(5)
        assert sorted(v[0] for v in out.values()) == [0, errors.ELOGOFF]
        assert done_msgs == ["m0"], done_msgs
        assert server.usercode_pool is None
    finally:
        release.set()
        ch.close()
        server.stop()


# ---- GOODBYE and revival ---------------------------------------------------

def test_goodbye_pulls_endpoint_before_first_probe(mesh):
    """GOODBYE removes the endpoint from a balancer while the first
    health-check probe is still 30 s away: the probe counter stays 0."""
    tflags.set_flag("health_check_interval_s", 30.0)
    servers = []
    lb = LocalityAwareLB()
    eps = [parse_endpoint("ici://4"), parse_endpoint("ici://5")]
    for ep in eps:
        lb.add_server(ep)
    try:
        for dev, tag in ((4, "a"), (5, "b")):
            # GOODBYE rides the Python plane's sockets, as in the JAX test
            s = rpc.Server(rpc.ServerOptions(native_ici=False))
            s.add_service(_echo_service(tag=tag))
            assert s.start(f"ici://{dev}") == 0
            servers.append(s)
        chans = {str(ep): _channel(str(ep)) for ep in eps}
        for ep in eps:
            c, r = _call(chans[str(ep)], "hi")
            assert not c.failed() and r.message.endswith("hi")
        assert {lb.select_server() for _ in range(64)} == set(eps)
        servers[0].stop(1.0)
        assert lameduck.is_draining(eps[0]), "GOODBYE never registered"
        task = health_check._tasks.get(eps[0])
        assert task is not None, "a drained peer must be under check"
        assert task.probe_count == 0
        for _ in range(50):
            assert lb.select_server() == eps[1]
        c, r = _call(chans["ici://5"], "after")
        assert not c.failed() and r.message == "b:after"
        for ch in chans.values():
            ch.close()
    finally:
        for ep in eps:
            t = health_check._tasks.get(ep)
            if t is not None:
                t.cancel()
            lameduck.clear_peer_draining(ep)
        for s in servers:
            s.stop()


def test_drained_restart_revived_by_health_checker(mesh):
    """drain → GOODBYE → health check → restart → probe → the peer mark
    clears and every balancer takes the endpoint back.  The probe runs
    here directly, so nothing waits on the checker's timer."""
    tflags.set_flag("health_check_interval_s", 30.0)
    ep = parse_endpoint("ici://6")
    lb = LocalityAwareLB()
    lb.add_server(ep)
    lb.add_server(parse_endpoint("ici://7"))
    # GOODBYE rides the Python plane's sockets, as in the JAX test
    server = rpc.Server(rpc.ServerOptions(native_ici=False))
    server.add_service(_echo_service(tag="v1"))
    assert server.start("ici://6") == 0
    ch = _channel("ici://6", max_retry=1)
    server2 = None
    try:
        c, r = _call(ch, "one", att=8192)
        assert not c.failed() and r.message == "v1:one"
        server.stop(0.5)
        assert lameduck.is_draining(ep) and health_check.checking(ep)
        task = health_check._tasks[ep]
        # nothing listens: the probe fails and the mark stays
        assert not task.probe_now()
        assert lameduck.is_draining(ep)
        assert all(lb.select_server() != ep for _ in range(32))
        server2 = rpc.Server(rpc.ServerOptions(native_ici=False))
        server2.add_service(_echo_service(tag="v2"))
        assert server2.start("ici://6") == 0
        assert task.probe_now(), "revival never fired"
        assert not health_check.checking(ep)
        assert not lameduck.is_draining(ep)
        assert ep in {lb.select_server() for _ in range(64)}
        c, r = _call(ch, "two", att=8192)
        assert not c.failed(), (c.error_code_, c.error_text_)
        assert r.message == "v2:two"
        assert len(c.response_attachment) == 8192
    finally:
        t = health_check._tasks.get(ep)
        if t is not None:
            t.cancel()
        lameduck.clear_peer_draining(ep)
        ch.close()
        server.stop()
        if server2 is not None:
            server2.stop()


def test_draining_listener_reads_down_to_the_probe(addr):
    server = rpc.Server()
    server.add_service(_echo_service(slow_messages=("slow",), slow_s=0.4))
    assert server.start(addr) == 0
    ep = parse_endpoint(addr)
    ch = _channel(addr)
    out = {}
    try:
        assert health_check.probe_endpoint(ep)
        evt = _async(ch, "slow", out)
        time.sleep(0.1)
        t = threading.Thread(target=lambda: server.stop(3.0))
        t.start()
        assert _wait(server.is_draining)
        assert not health_check.probe_endpoint(ep)
        assert lameduck.is_draining(ep)
        t.join(5)
        assert evt.wait(5) and out["slow"][0] == 0
        assert not health_check.probe_endpoint(ep)
    finally:
        tk = health_check._tasks.get(ep)
        if tk is not None:
            tk.cancel()
        lameduck.clear_peer_draining(ep)
        ch.close()
        server.stop()


def test_lameduck_registry_agrees_with_the_jax_package(mesh):
    """The local and peer marks and the balancer exclusion, step for
    step, on both packages' registries."""
    from brpc_tpu.butil.endpoint import parse_endpoint as jparse
    from brpc_tpu.policy.load_balancers import LocalityAwareLB as JLALB
    from brpc_tpu.rpc import health_check as jhealth
    tflags.set_flag("health_check_interval_s", 30.0)
    from brpc_tpu.butil import flags as jflags
    jold = jflags.get_flag("health_check_interval_s")
    jflags.set_flag("health_check_interval_s", 30.0)
    sides = [(jlameduck, jhealth, JLALB(), jparse),
             (lameduck, health_check, LocalityAwareLB(), parse_endpoint)]
    seen = []
    try:
        for ld, hc, lb, parse in sides:
            a, b = parse("ici://3"), parse("ici://4")
            lb.add_server(a)
            lb.add_server(b)
            steps = []
            ld.mark_local_draining(a)
            steps.append((ld.is_draining(a), ld.is_draining(b)))
            ld.clear_local_draining(a)
            steps.append(ld.is_draining(a))
            steps.append(ld.notify_peer_draining(b))
            steps.append(ld.notify_peer_draining(b))     # idempotent
            steps.append((ld.is_draining(b), hc.checking(b)))
            steps.append(sorted(str(lb.select_server()) for _ in range(8)))
            ld.clear_peer_draining(b)
            hc._tasks[b].cancel()
            steps.append((ld.is_draining(b),
                          b in {lb.select_server() for _ in range(64)}))
            seen.append(steps)
    finally:
        jflags.set_flag("health_check_interval_s", jold)
    assert seen[0] == seen[1]
    assert seen[1][2] is True and seen[1][3] is False


# ---- the device-plane drain gate -----------------------------------------

def _posted(mesh):
    plane = dp.DevicePlane.instance()
    arr = mesh.own(torch.zeros(65536, dtype=torch.uint8), 0)
    released = []
    t = plane.post_send(arr, 0, 1, mesh=mesh)
    t.add_source_release(lambda: released.append(1))
    return plane, t, released


def test_drain_waits_for_posted_transfer(mesh):
    plane, t, released = _posted(mesh)
    assert plane.active_transfers() >= 1
    threading.Timer(0.4, lambda: plane.post_recv(t.uuid)).start()
    server = rpc.Server()
    server.add_service(_echo_service())
    assert server.start("mem://dplane-drain") == 0
    t0 = time.monotonic()
    server.stop(5.0)
    dt = time.monotonic() - t0
    assert 0.3 <= dt < 3.0, dt
    assert t.state == dp.COMPLETE
    assert released == [1], "the source pin releases at completion"
    assert plane.active_transfers() == 0 and plane.pending_sends() == 0
    assert torch.equal(t.out, torch.zeros(65536, dtype=torch.uint8))


def test_grace_expiry_fails_unmatched_send_releasing_pin(mesh):
    plane, t, released = _posted(mesh)
    server = rpc.Server()
    server.add_service(_echo_service())
    assert server.start("mem://dplane-straggle") == 0
    server.stop(0.3)
    assert t.state == dp.FAILED, t.state
    assert t.poll() and t.wait(0) != 0
    assert released == [1], "a lame-duck stop must never leak a pin"
    assert plane.pending_sends() == 0 and plane.active_transfers() == 0


def test_fail_pending_spares_sends_posted_after_the_drain_began(mesh):
    plane, old, released_old = _posted(mesh)
    cutoff = time.monotonic_ns()
    time.sleep(0.001)
    _, new, released_new = _posted(mesh)
    assert plane.fail_pending("test", posted_before_ns=cutoff) == 1
    assert old.state == dp.FAILED and released_old == [1]
    assert new.state == dp.POSTED and released_new == []
    plane.post_recv(new.uuid)
    assert new.state == dp.COMPLETE and released_new == [1]
    assert plane.active_transfers() == 0


# ---- hygiene ---------------------------------------------------------------

def test_stop_start_cycles_no_thread_leak(addr):
    def census():
        return {t for t in threading.enumerate() if t.is_alive()}

    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          usercode_backup_threads=2))
    server.add_service(_echo_service())
    assert server.start(addr) == 0
    # a retry covers a call racing the old connection's EOF after a stop
    ch = _channel(addr, max_retry=2)
    c, _ = _call(ch, "warmup")
    assert not c.failed()
    server.stop()
    server.join(2.0)
    assert _wait(lambda: not [t for t in census()
                              if t.name.startswith("usercode")], 5.0)
    before = census()
    try:
        for i in range(3):
            assert server.start(addr) == 0, i
            c, r = _call(ch, f"cycle{i}")
            assert not c.failed(), (c.error_code_, c.error_text_)
            assert r.message == f"srv:cycle{i}"
            server.stop(0.2)
            server.join(2.0)
        assert _wait(lambda: not (census() - before), 5.0), \
            [t.name for t in census() - before]
    finally:
        ch.close()
        server.stop()


def test_join_waits_for_inflight_handlers():
    finished = threading.Event()
    server = rpc.Server()
    server.add_service(_echo_service(slow_messages=("slow",), slow_s=0.5,
                                     finished=finished))
    assert server.start("mem://join-inflight") == 0
    ch = _channel("mem://join-inflight")
    out = {}
    try:
        evt = _async(ch, "slow", out)
        time.sleep(0.1)
        server.stop()         # immediate stop: the handler still runs
        server.join(5.0)
        assert finished.is_set(), "join() waits for in-flight handlers"
        assert server.inflight_requests() == 0
        assert evt.wait(5) and out["slow"][0] == errors.ELOGOFF
    finally:
        ch.close()


def test_stop_reentrancy_inner_returns_second_waits():
    """A stop from a thread the drain itself runs returns at once; a
    second concurrent stop waits for the first to finish."""
    inner = {}
    second = {}
    entered = threading.Event()
    server = rpc.Server()

    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            entered.set()
            time.sleep(0.3)
            response.message = "ok"
            done()

    server.add_service(Echo())
    assert server.start("mem://reentrant") == 0
    ch = _channel("mem://reentrant")
    out = {}
    try:
        evt = _async(ch, "x", out)
        assert entered.wait(3)
        t_first = threading.Thread(target=lambda: server.stop(3.0))
        t_first.start()
        assert _wait(server.is_draining)
        assert server._stopping_thread is t_first
        t_second = threading.Thread(target=lambda: (
            server.stop(3.0), second.update(done=time.monotonic(),
                                            running=server.is_running())))
        t_second.start()
        time.sleep(0.05)
        assert t_second.is_alive(), "a second stop must wait"
        t_first.join(5)
        first_done = time.monotonic()
        t_second.join(5)
        assert second["done"] >= first_done - 0.05
        assert second["running"] is False
        assert evt.wait(5) and out["x"][0] == 0
        # reentrancy: stop() from inside the drain (a handler of the
        # stopping thread) returns immediately
        server.start("mem://reentrant")
        t_third = threading.Thread(target=lambda: server.stop(3.0))
        orig = server._drain_until

        def drain_and_reenter(deadline):
            t0 = time.monotonic()
            server.stop(3.0)
            inner["dt"] = time.monotonic() - t0
            return orig(deadline)
        server._drain_until = drain_and_reenter
        t_third.start()
        t_third.join(5)
        assert inner["dt"] < 0.1 and not server.is_running()
    finally:
        ch.close()
        server.stop()


_SIGTERM_CHILD = r"""
import sys, threading, time
sys.path.insert(0, %(repo)r)
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
finished = []

class Echo(rpc.Service):
    SERVICE_NAME = "EchoService"
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        time.sleep(0.5)
        finished.append(request.message)
        response.message = "srv:" + request.message
        done()

server = rpc.Server(rpc.ServerOptions(graceful_shutdown_s=5.0,
                                      graceful_quit_on_sigterm=True))
server.add_service(Echo())
assert server.start("mem://gq-child") == 0
ch = rpc.Channel()
ch.init("mem://gq-child", options=rpc.ChannelOptions(timeout_ms=8000,
                                                     max_retry=0))
results = {}
evt = threading.Event()
c = rpc.Controller()
ch.call_method("EchoService.Echo", c, EchoRequest(message="inflight"),
               EchoResponse,
               done=lambda c: (results.update(code=c.error_code_), evt.set()))
time.sleep(0.1)
print("UP", flush=True)
server.join()
assert evt.wait(5), "in-flight call never completed"
assert results["code"] == 0, results
assert finished == ["inflight"], finished
print("DRAINED", flush=True)
"""


def test_sigterm_drains_inflight_then_process_exits_cleanly():
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD % {"repo": REPO}],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        deadline = time.monotonic() + 60
        while "UP" not in line and time.monotonic() < deadline and line:
            line = proc.stdout.readline()
        assert "UP" in line, line
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    except Exception:
        proc.kill()
        raise
    assert proc.returncode == 0, out
    assert "DRAINED" in out, out
