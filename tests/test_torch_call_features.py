"""The client's call features, the Socket.write fault injector, session
and thread data and isolated handlers: the port held against the JAX
package on the CPU.

  * The JAX package's ``tests/test_fault_injection.py`` (10 tests),
    ``test_integration.py::TestCancel``, ``test_misc_features.py``'s
    ``TestNsFilter`` and ``TestConnectionTypes``, the in-process cases of
    ``test_controller_pool.py`` and
    ``test_admission.py::test_hedging_does_not_amplify_into_retry_storm``
    run on both packages over ``mem://`` (the JAX package's loopback fast
    plane off where it would bypass the sockets counted).
  * Parity on seeded inputs: the same seed gives both injectors the same
    decisions and ``injected`` counts, the same calls through seeded
    drops end with the same error codes and try counts, equal (cid, try)
    give equal backoff delays, a filter keeps the same members, and both
    packages hold the same pooled and short connections.
  * The port on a CPU ``ici://`` mesh with its device plane engaged: a
    backup request, a cancelled call and dropped frames with DEVICE
    attachments; a dropped frame posts no transfer.
"""
from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.bthread import id as jbid
from brpc_tpu.butil import flags as jfl
from brpc_tpu.butil.endpoint import parse_endpoint as jparse
from brpc_tpu.rpc import controller as jctl
from brpc_tpu.rpc import errors as jerrors
from brpc_tpu.rpc import fault_injection as jfi
from brpc_tpu.rpc.admission import AdmissionOptions as JAdmissionOptions
from brpc_tpu.rpc.socket_map import SocketMap as JSocketMap
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.bthread import id as tbid
from brpc_tpu_torch.butil import flags as tfl
from brpc_tpu_torch.butil.endpoint import parse_endpoint as tparse
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import controller as tctl
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import fault_injection as tfi
from brpc_tpu_torch.rpc.admission import AdmissionOptions
from brpc_tpu_torch.rpc.socket_map import SocketMap
from tests.echo_pb2 import (EchoRequest as JEchoRequest,
                            EchoResponse as JEchoResponse)
from tests.torch_census import custody_census  # noqa: F401  (fixture)

JAX = types.SimpleNamespace(
    name="jax", rpc=jrpc, fi=jfi, errors=jerrors, bid=jbid, flags=jfl,
    ctl=jctl, parse=jparse, smap=JSocketMap, Req=JEchoRequest,
    Resp=JEchoResponse, Adm=JAdmissionOptions)
PORT = types.SimpleNamespace(
    name="port", rpc=rpc, fi=tfi, errors=errors, bid=tbid, flags=tfl,
    ctl=tctl, parse=tparse, smap=SocketMap, Req=EchoRequest,
    Resp=EchoResponse, Adm=AdmissionOptions)
PKGS = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]

_seq = [0]


def unique(p):
    _seq[0] += 1
    return f"cf-{p}-{_seq[0]}"


def _port_idle():
    return (not rpc.list_sockets()
            and tctl.server_controller_pool.live() == 0
            and dp.plane().active_transfers() == 0)


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server, channel and injector here is closed by its test: at
    teardown the port's sockets, pooled server Controllers and plane
    transfers are all returned, and no injector is left installed."""
    yield
    tfi.install(None)
    jfi.install(None)
    deadline = time.monotonic() + 3.0
    while not _port_idle() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _port_idle(), (rpc.list_sockets(),
                          tctl.server_controller_pool.live())


@pytest.fixture()
def no_loopback():
    """Both packages' mem:// loopback planes off, so the calls ride
    sockets (restored after)."""
    old = (jfl.get_flag("mem_loopback_fast"),
           tfl.get_flag("mem_loopback_fast"))
    jfl.set_flag("mem_loopback_fast", False)
    tfl.set_flag("mem_loopback_fast", False)
    yield
    jfl.set_flag("mem_loopback_fast", old[0])
    tfl.set_flag("mem_loopback_fast", old[1])


def _echo_service(pkg, tag):
    class EchoService(pkg.rpc.Service):
        def __init__(self):
            self.calls = 0

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            self.calls += 1
            response.message = f"{tag}:{request.message}"
            done()
    return EchoService()


def start(pkg, tag, **opts):
    server = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts) if opts else None)
    svc = _echo_service(pkg, tag)
    server.add_service(svc)
    target = f"mem://{unique(pkg.name + tag)}"
    assert server.start(target) == 0
    return server, svc, target


def call(pkg, ch, msg="x", cntl=None):
    cntl = cntl or pkg.rpc.Controller()
    resp = ch.call_method("EchoService.Echo", cntl, pkg.Req(message=msg),
                          pkg.Resp)
    return cntl, resp


def channel(pkg, target, lb="", **kw):
    ch = pkg.rpc.Channel()
    ch.init(target, lb, options=pkg.rpc.ChannelOptions(**kw))
    return ch


# ---------------------------------------------------------------------
# test_fault_injection.py, on both packages
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
class TestFaultInjection:
    def test_no_injector_no_effect(self, pkg):
        server, svc, target = start(pkg, "a")
        try:
            cntl, resp = call(pkg, channel(pkg, target))
            assert not cntl.failed() and resp.message == "a:x"
        finally:
            server.stop()

    def test_total_drop_times_out(self, pkg):
        server, svc, target = start(pkg, "a")
        try:
            ch = channel(pkg, target, timeout_ms=200, max_retry=0)
            with pkg.fi.inject(pkg.fi.FaultInjector(drop_ratio=1.0)) as inj:
                cntl, _ = call(pkg, ch)
                assert cntl.failed()
                assert cntl.error_code == pkg.errors.ERPCTIMEDOUT
                assert inj.injected[pkg.fi.DROP] >= 1
            assert svc.calls == 0
        finally:
            server.stop()

    def test_request_drops_recovered_by_retry(self, pkg):
        """Try 0's request vanishes; the hedge answers, and the versioned
        correlation id takes try 1's response."""
        server, svc, target = start(pkg, "a")
        fi = pkg.fi
        try:
            ch = channel(pkg, target, timeout_ms=300, max_retry=3,
                         retry_on_timeout=True)
            state = {"dropped": False}

            class OneShot(fi.FaultInjector):
                def decide(self, socket):
                    if not state["dropped"] and not socket.is_server_side:
                        state["dropped"] = True
                        self.injected[fi.DROP] += 1
                        return fi.DROP
                    return fi.PASS

            with fi.inject(OneShot()):
                cntl, resp = call(pkg, ch, "r")
                assert not cntl.failed(), cntl.error_text
                assert resp.message == "a:r"
        finally:
            server.stop()

    def test_injected_sever_fails_fast_not_timeout(self, pkg):
        server, svc, target = start(pkg, "a")
        try:
            ch = channel(pkg, target, timeout_ms=2000, max_retry=0)
            t0 = time.monotonic()
            with pkg.fi.inject(pkg.fi.FaultInjector(error_ratio=1.0)):
                cntl, _ = call(pkg, ch)
                assert cntl.failed()
            assert time.monotonic() - t0 < 1.0   # severed, not timed out
        finally:
            server.stop()

    def test_delay_triggers_backup_request(self, pkg):
        """A stall on try 0's path makes the backup request win."""
        server, svc, target = start(pkg, "a")
        fi = pkg.fi
        try:
            ch = channel(pkg, target, timeout_ms=3000, max_retry=1,
                         backup_request_ms=50)
            first = {"seen": False}

            class DelayFirst(fi.FaultInjector):
                def decide(self, socket):
                    if not first["seen"] and not socket.is_server_side:
                        first["seen"] = True
                        time.sleep(0.4)       # stall try 0's request
                    return fi.PASS

            with fi.inject(DelayFirst()):
                cntl, resp = call(pkg, ch, "b")
                assert not cntl.failed(), cntl.error_text
                assert resp.message == "a:b"
                assert cntl.retried_count == 1
        finally:
            server.stop()

    def test_timeout_is_final_without_optin(self, pkg):
        """By default a dropped request dies at the overall deadline, with
        no hedging (reference HandleTimeout)."""
        server, svc, target = start(pkg, "a")
        try:
            ch = channel(pkg, target, timeout_ms=200, max_retry=3)
            with pkg.fi.inject(pkg.fi.FaultInjector(drop_ratio=1.0)):
                t0 = time.monotonic()
                cntl, _ = call(pkg, ch)
                dt = time.monotonic() - t0
            assert cntl.failed()
            assert cntl.error_code == pkg.errors.ERPCTIMEDOUT
            assert dt >= 0.15          # the whole deadline, not a share
            assert cntl.retried_count == 0
        finally:
            server.stop()

    def test_drop_recovered_end_to_end_single_server(self, pkg):
        server, svc, target = start(pkg, "a")
        fi = pkg.fi
        try:
            ch = channel(pkg, target, timeout_ms=600, max_retry=1,
                         retry_on_timeout=True)
            state = {"n": 0}

            class DropFirst(fi.FaultInjector):
                def decide(self, socket):
                    if socket.is_server_side:
                        return fi.PASS
                    state["n"] += 1
                    if state["n"] == 1:
                        self.injected[fi.DROP] += 1
                        return fi.DROP       # try 0 vanishes
                    return fi.PASS           # the hedge passes

            with fi.inject(DropFirst()):
                cntl, resp = call(pkg, ch, "s")
                assert not cntl.failed(), cntl.error_text
                assert resp.message == "a:s"
        finally:
            server.stop()

    def test_straggler_error_does_not_fail_live_hedge(self, pkg):
        """After a hedge advanced current_try, a late connection error at
        the abandoned try's version neither fails the call nor blacklists
        the live try's server."""
        bid = pkg.bid
        cntl = pkg.rpc.Controller()
        cntl.timeout_ms = 1000
        cntl.max_retry = 1
        cntl.retry_on_timeout = True
        cntl._start_us = time.monotonic_ns() // 1000
        cntl._cid = bid.create_ranged(cntl, cntl._on_rpc_event, 2)
        cntl.current_try = 1              # hedge already in flight
        cntl._selected_endpoint = "live-server"
        rc = bid.error(bid.with_version(cntl._cid, 0),
                       pkg.errors.ECONNRESET)
        assert rc == 0                    # delivered: v0 is still lockable
        assert not cntl.failed()          # ...but does not decide the call
        assert not cntl._ended.is_set()
        assert "live-server" not in cntl._excluded_servers
        rc = bid.error(bid.with_version(cntl._cid, 1),
                       pkg.errors.ECONNRESET)
        assert rc == 0
        assert cntl.failed() and cntl.error_code == pkg.errors.ECONNRESET
        assert cntl._ended.is_set()

    def test_backup_request_still_times_out_when_all_tries_blackholed(
            self, pkg):
        """A backup advances current_try; the version-bound deadline timer
        is re-armed at the new version, or the call never times out."""
        server, svc, target = start(pkg, "a")
        try:
            ch = channel(pkg, target, timeout_ms=400, max_retry=1,
                         backup_request_ms=50)
            with pkg.fi.inject(pkg.fi.FaultInjector(drop_ratio=1.0)):
                t0 = time.monotonic()
                cntl, _ = call(pkg, ch)
                dt = time.monotonic() - t0
            assert cntl.failed()
            assert cntl.error_code == pkg.errors.ERPCTIMEDOUT
            assert dt < 2.0, f"hung {dt:.1f}s instead of timing out"
        finally:
            server.stop()

    def test_match_scopes_faults_to_one_backend(self, pkg):
        """Drops scoped to server A: a balanced channel over A and B keeps
        succeeding through B (hedge and exclusion)."""
        sa, svca, ta = start(pkg, "A")
        sb, svcb, tb = start(pkg, "B")
        try:
            ch = channel(pkg, f"list://{ta.split('://')[1]},"
                              f"{tb.split('://')[1]}", "rr",
                         timeout_ms=300, max_retry=3, retry_on_timeout=True)
            a_host = ta.split("://")[1]

            def match(socket):
                return (socket.remote_side is not None
                        and a_host in str(socket.remote_side)
                        and not socket.is_server_side)

            with pkg.fi.inject(pkg.fi.FaultInjector(drop_ratio=1.0,
                                                    match=match)):
                ok = 0
                for i in range(6):
                    cntl, resp = call(pkg, ch, str(i))
                    if not cntl.failed() and resp.message.startswith("B:"):
                        ok += 1
                assert ok == 6, f"only {ok}/6 failed over to B"
            assert svcb.calls >= 6 and svca.calls == 0
            ch.close()
        finally:
            sa.stop()
            sb.stop()


# ---------------------------------------------------------------------
# seeded parity
# ---------------------------------------------------------------------

class _Sock:
    def __init__(self, server_side):
        self.is_server_side = server_side
        self.remote_side = None


def test_constants_and_error_codes_agree():
    assert (tfi.PASS, tfi.DROP, tfi.ERROR) == (jfi.PASS, jfi.DROP, jfi.ERROR)
    for name in ("ECANCELED", "ERPCTIMEDOUT", "EBACKUPREQUEST",
                 "EFAILEDSOCKET", "ECLOSE"):
        assert getattr(errors, name) == getattr(jerrors, name)


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_same_seed_same_decisions_and_counts(seed):
    """The same seed and the same sockets give both injectors the same
    decision sequence and the same ``injected`` counts."""
    rng = np.random.default_rng(seed)
    sides = rng.integers(0, 2, 400).astype(bool)
    out = []
    for fi in (jfi, tfi):
        inj = fi.FaultInjector(drop_ratio=0.3, error_ratio=0.1, seed=seed,
                               match=lambda s: not s.is_server_side)
        out.append(([inj.decide(_Sock(bool(x))) for x in sides],
                    dict(inj.injected)))
    assert out[0] == out[1]
    assert out[0][1]["drop"] > 0 and out[0][1]["error"] > 0


@pytest.mark.parametrize("seed", [3, 11])
def test_seeded_drops_same_codes_and_tries(no_loopback, seed):
    """Sixteen sequential calls through seeded drops of every write (the
    request and the response) with timeout hedging: both packages end
    each call with the same error code and the same try count, and count
    the same drops."""
    outcomes = []
    for pkg in (JAX, PORT):
        server, svc, target = start(pkg, "d")
        # 300 ms a try: only a seeded drop makes a try time out, never a
        # loaded host's slow answer (which would spend one more write of
        # the seeded sequence on one side only)
        ch = channel(pkg, target, timeout_ms=1200, max_retry=3,
                     retry_on_timeout=True)
        try:
            calls = []
            with pkg.fi.inject(pkg.fi.FaultInjector(drop_ratio=0.3,
                                                    seed=seed)) as inj:
                for i in range(16):
                    cntl, resp = call(pkg, ch, str(i))
                    calls.append((cntl.error_code, cntl.retried_count,
                                  None if cntl.failed() else resp.message))
            outcomes.append((calls, dict(inj.injected)))
        finally:
            ch.close()
            server.stop()
    assert outcomes[0] == outcomes[1]
    calls, injected = outcomes[1]
    assert injected["drop"] > 0
    assert any(r > 0 for _, r, _ in calls)


def test_retry_backoff_equal_for_equal_cid_and_try():
    """``_retry_backoff_s`` is deterministic in (cid, retry): both
    packages give the same delay, doubling per retry up to 1 s."""
    for base in (0, 5, 40):
        for cid in (1, 0x1234_0000_0001, 987654321):
            for retried in (1, 2, 3, 7):
                got = []
                for pkg in (JAX, PORT):
                    c = pkg.rpc.Controller()
                    c._cid = cid
                    c.retried_count = retried
                    c.retry_backoff_ms = base
                    got.append(c._retry_backoff_s())
                assert got[0] == got[1]
                if base:
                    cap = min(base * 2 ** (retried - 1), 1000.0) / 1000.0
                    assert cap <= got[1] <= 1.25 * cap
                else:
                    assert got[1] == 0.0


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_backoff_spaces_connection_retries(pkg):
    """A refused endpoint with ``retry_backoff_ms``: the retries wait out
    the doubling delays, and the call fails with the connect error after
    max_retry + 1 tries."""
    target = f"mem://{unique('nobody')}"
    ch = channel(pkg, target, timeout_ms=5000, max_retry=2,
                 retry_backoff_ms=40)
    t0 = time.monotonic()
    cntl, _ = call(pkg, ch)
    dt = time.monotonic() - t0
    assert cntl.failed() and cntl.retried_count == 2
    assert dt >= 0.04 + 0.08
    ch.close()


# ---------------------------------------------------------------------
# cancel (test_integration.py::TestCancel)
# ---------------------------------------------------------------------

def _slow_server(pkg, sleep_s=0.3):
    class SlowService(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            time.sleep(sleep_s)
            response.message = "late"
            done()

    server = pkg.rpc.Server()
    server.add_service(SlowService())
    target = f"mem://{unique('cancel')}"
    assert server.start(target) == 0
    return server, target


@pytest.mark.parametrize("pkg", PKGS)
def test_cancel_inflight(pkg):
    server, target = _slow_server(pkg)
    try:
        ch = channel(pkg, target, timeout_ms=5000, max_retry=0)
        cntl = pkg.rpc.Controller()
        done_evt = threading.Event()
        ch.call_method("EchoService.Echo", cntl, pkg.Req(message="x"),
                       pkg.Resp, lambda c: done_evt.set())
        time.sleep(0.05)
        cntl.cancel()
        assert done_evt.wait(5)
        assert cntl.error_code == pkg.errors.ECANCELED
        time.sleep(0.4)          # the late response is dropped silently
        assert cntl.error_code == pkg.errors.ECANCELED
        assert cntl.response is None
        ch.close()
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_cancel_after_end_is_a_no_op(pkg):
    server, svc, target = start(pkg, "c")
    try:
        ch = channel(pkg, target)
        cntl, resp = call(pkg, ch, "k")
        cntl.cancel()
        assert not cntl.failed() and resp.message == "c:k"
        ch.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------
# ns_filter and connection types (test_misc_features.py)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_ns_filter_excludes_tagged_servers(pkg, tmp_path):
    names = [unique("nsf") for _ in range(3)]
    servers = []
    for name in names:
        s = pkg.rpc.Server()
        s.add_service(_echo_service(pkg, name))
        assert s.start(f"mem://{name}") == 0
        servers.append(s)
    listing = tmp_path / "servers"
    listing.write_text(f"mem://{names[0]} 100 keep\n"
                       f"mem://{names[1]} 100 drop\n"
                       f"mem://{names[2]} 100 keep\n")
    opts = pkg.rpc.ChannelOptions(timeout_ms=1000)
    opts.ns_filter = lambda e: e.tag != "drop"
    ch = pkg.rpc.Channel()
    assert ch.init(f"file://{listing}", "rr", opts) == 0
    try:
        assert ch._lb.server_count() == 2
        assert sorted(str(e.endpoint) for e in ch._lb.servers()) == \
            sorted(f"mem://{n}" for n in (names[0], names[2]))
        seen = set()
        for _ in range(6):
            cntl, resp = call(pkg, ch, "f")
            assert not cntl.failed()
            seen.add(resp.message.split(":")[0])
        assert seen == {names[0], names[2]}
    finally:
        ch.close()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("ctype", ["pooled", "short"])
def test_connection_type_works(pkg, ctype):
    server, svc, target = start(pkg, "t")
    try:
        ch = channel(pkg, target, connection_type=ctype, timeout_ms=2000)
        for i in range(5):
            cntl, resp = call(pkg, ch, f"c{i}")
            assert not cntl.failed(), cntl.error_text
            assert resp.message == f"t:c{i}"
        ch.close()
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_connection_type_rejected(pkg):
    ch = pkg.rpc.Channel()
    with pytest.raises(ValueError):
        ch.init("mem://x", options=pkg.rpc.ChannelOptions(
            connection_type="bogus"))


def test_pooled_and_short_connection_counts_agree(no_loopback):
    """Ten sequential calls per connection type: both packages hold the
    same connections (``SocketMap.stats()``) and their servers see the
    same connections open; pooled calls reuse one, short ones close
    each."""
    counts = {}
    for pkg in (JAX, PORT):
        for ctype in ("single", "pooled", "short"):
            server, svc, target = start(pkg, "n")
            try:
                ch = channel(pkg, target, connection_type=ctype,
                             timeout_ms=2000)
                for _ in range(10):
                    cntl, _ = call(pkg, ch, "p")
                    assert not cntl.failed(), cntl.error_text
                ep = pkg.parse(target)
                held = pkg.smap.instance().stats().get(ep, 0)
                # a short connection's close reaches the server after
                # the call returned
                deadline = time.monotonic() + 3
                while len(server.connections()) > held and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)
                counts[(pkg.name, ctype)] = (held,
                                             len(server.connections()))
                ch.close()
            finally:
                server.stop()
    for ctype in ("single", "pooled", "short"):
        assert counts[("jax", ctype)] == counts[("port", ctype)], counts
    assert counts[("port", "pooled")] == (1, 1)
    assert counts[("port", "short")] == (0, 0)


def test_pooled_concurrent_calls_hold_separate_connections(no_loopback):
    """Concurrent pooled calls each hold a connection of their own, and
    all of them return to the pool."""
    gate = threading.Event()
    entered = []

    class Blocking(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            entered.append(1)
            gate.wait(5)
            done()

    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True))
    server.add_service(Blocking())
    target = f"mem://{unique('pool3')}"
    assert server.start(target) == 0
    ch = channel(PORT, target, connection_type="pooled", timeout_ms=5000)
    try:
        ts = [threading.Thread(target=call, args=(PORT, ch))
              for _ in range(3)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 5
        while len(entered) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(server.connections()) == 3
        gate.set()
        for t in ts:
            t.join(5)
        assert SocketMap.instance().stats()[tparse(target)] == 3
    finally:
        gate.set()
        ch.close()
        server.stop()


# ---------------------------------------------------------------------
# the server-side Controller pool (test_controller_pool.py, in process)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
class TestPoolUnit:
    def test_reuse_presents_pristine_state(self, pkg):
        pool = pkg.ctl.ControllerPool()
        c = pool.acquire()
        c.set_failed(1003, "deliberate")
        c.log_id = 77
        c.request_attachment.append(b"req-bytes")
        c.response_attachment.append(b"resp-bytes")
        c.span = object()
        c.trace_id = 123
        c._session_data = {"scratch": 1}
        c.backup_request_ms = 5
        pool.release(c)
        c2 = pool.acquire()
        assert c2 is c
        assert c2.error_code_ == 0 and c2.error_text_ == ""
        assert not c2.failed() and c2.log_id == 0
        assert c2._peek_request_attachment() is None
        assert c2._peek_response_attachment() is None
        assert len(c2.request_attachment) == 0
        assert c2.span is None and c2.trace_id == 0
        assert c2._session_data is None
        assert c2.backup_request_ms is None
        pool.release(c2)

    def test_versioned_ids_reject_double_release(self, pkg):
        pool = pkg.ctl.ControllerPool()
        a = pool.acquire()
        assert pool.live() == 1
        pool.release(a)
        assert pool.live() == 0
        free_before = pool.free_count()
        pool.release(a)                      # a stale release: rejected
        assert pool.free_count() == free_before
        assert pool.live() == 0

    def test_live_enumeration(self, pkg):
        pool = pkg.ctl.ControllerPool()
        a, b = pool.acquire(), pool.acquire()
        assert pool.live() == 2
        assert set(map(id, pool.live_controllers())) == {id(a), id(b)}
        pool.release(a)
        pool.release(b)
        assert pool.live() == 0

    def test_capacity_bounds_free_list(self, pkg):
        pool = pkg.ctl.ControllerPool(capacity=2)
        cs = [pool.acquire() for _ in range(5)]
        for c in cs:
            pool.release(c)
        assert pool.free_count() == 2
        assert pool.live() == 0


def _stain_service(pkg):
    class Stain(pkg.rpc.Service):
        """A staining failure (error, attachment, log id) alternates with
        a clean echo, so consecutive requests reuse one shim."""
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            if request.message == "stain":
                cntl.response_attachment.append(b"stain" * 100)
                cntl.log_id = 999
                cntl.set_failed(1003, "stained")
                done()
                return
            assert cntl.error_code_ == 0, "stale error code leaked"
            assert cntl.log_id == 0, "stale log_id leaked"
            att = cntl._peek_response_attachment()
            assert att is None or len(att) == 0, "stale attachment leaked"
            response.message = request.message
            done()
    return Stain()


@pytest.mark.parametrize("pkg", PKGS)
def test_pool_reuse_clean_over_mem(pkg):
    server = pkg.rpc.Server()
    server.add_service(_stain_service(pkg))
    target = f"mem://{unique('cpool')}"
    assert server.start(target) == 0
    try:
        live0 = pkg.ctl.server_controller_pool.live()
        ch = channel(pkg, target, timeout_ms=10000, max_retry=0)
        for i in range(40):
            c1, _ = call(pkg, ch, "stain")
            assert c1.error_code_ == 1003, (c1.error_code_, c1.error_text_)
            c2, resp = call(pkg, ch, f"ok{i}")
            assert not c2.failed(), c2.error_text
            assert resp.message == f"ok{i}"
        ch.close()
        assert pkg.ctl.server_controller_pool.live() == live0
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_pool_reaches_steady_state_under_sustained_load(pkg):
    """Sustained concurrent load grows the free list to the concurrency
    high-water mark and then stops: the pool reuses."""
    server = pkg.rpc.Server()
    server.add_service(_stain_service(pkg))
    target = f"mem://{unique('steady')}"
    assert server.start(target) == 0
    pool = pkg.ctl.server_controller_pool
    try:
        ch = channel(pkg, target, timeout_ms=10000, max_retry=0)

        def worker(k):
            for i in range(30):
                c, _ = call(pkg, ch, f"w{k}-{i}")
                assert not c.failed(), c.error_text

        def burst():
            ts = [threading.Thread(target=worker, args=(k,))
                  for k in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()

        burst()
        mark = pool.free_count()
        burst()
        assert pool.free_count() <= max(mark, 1), (mark, pool.free_count())
        ch.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------
# hedging against a shedding server (test_admission.py)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_hedging_does_not_amplify_into_retry_storm(pkg):
    """Backup-request hedging against a shedding server: the shed hint
    gates every re-dispatch, so one call lands at most max_retry + 1
    tries on the server, never a storm."""
    gate = threading.Event()
    entered = []

    class Echo(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            if request.message == "block":
                entered.append(1)
                gate.wait(10)
            response.message = f"{cntl.priority}/{cntl.tenant}"
            done()

    opts = pkg.rpc.ServerOptions()
    opts.max_concurrency = 2
    opts.admission = pkg.Adm(max_queue_ms=2000.0, service_rate_override=10.0)
    server = pkg.rpc.Server(opts)
    server.add_service(Echo())
    target = f"mem://{unique('storm')}"
    assert server.start(target) == 0
    ch = channel(pkg, target, timeout_ms=600, max_retry=2,
                 backup_request_ms=20)
    threads = []
    try:
        for _ in range(2):
            def blocker():
                c = pkg.rpc.Controller()
                c.priority = 0
                # the blockers do not hedge: their backups would queue
                # and shed at their deadline inside the counted window
                c.backup_request_ms = 0
                ch.call_method("Echo.Echo", c, pkg.Req(message="block"),
                               pkg.Resp)
            t = threading.Thread(target=blocker)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 5
        while len(entered) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(entered) == 2, "server slots did not fill"
        shed_before = server.admission.shed_total.get_value()
        c = pkg.rpc.Controller()
        c.priority = 3
        ch.call_method("Echo.Echo", c, pkg.Req(message="x"), pkg.Resp)
        assert c.failed()
        time.sleep(0.3)          # straggler re-issues land in the window
        shed_delta = server.admission.shed_total.get_value() - shed_before
        assert 1 <= shed_delta <= 4, shed_delta
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_shed_leaves_the_backup_timer_armed(pkg):
    """A shed whose hint outlasts backup_request_ms: the backup timer
    stays armed through the shed, so a backup try reaches the server
    before the hint has passed and answers the call, at the same try
    version on both packages.  Tries are counted on the server."""
    hint_ms = 1000
    arrivals = []

    class Echo(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            arrivals.append(time.monotonic())
            if len(arrivals) == 1:
                cntl.set_failed(pkg.errors.ELIMIT, "shed")
                cntl.retry_after_ms = hint_ms
            else:
                response.message = request.message
            done()

    server = pkg.rpc.Server()
    server.add_service(Echo())
    target = f"mem://{unique('shedbk')}"
    assert server.start(target) == 0
    ch = channel(pkg, target, timeout_ms=5000, max_retry=3,
                 backup_request_ms=30)
    try:
        t0 = time.monotonic()
        cntl, resp = call(pkg, ch, "bk")
        dt = time.monotonic() - t0
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "bk"
        # the shed's retry and the backup each took one version
        assert (cntl.current_try, cntl.retried_count) == (2, 2)
        assert dt < hint_ms / 1000.0, dt
        early = [a for a in arrivals if a - arrivals[0] < hint_ms / 1000.0]
        assert len(early) == 2, arrivals
    finally:
        ch.close()
        server.stop()


# ---------------------------------------------------------------------
# session and thread data, isolated handlers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_session_local_data_is_pooled(pkg, no_loopback):
    """A handler's session data comes from the server's pool and goes
    back once the response is sent: sequential calls reuse one object."""
    made = []

    def factory():
        made.append({"n": 0})
        return made[-1]

    class Sess(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            d = cntl.session_local_data()
            d["n"] += 1
            response.message = str(d["n"])
            done()

    opts = pkg.rpc.ServerOptions()
    opts.session_local_data_factory = factory
    server = pkg.rpc.Server(opts)
    server.add_service(Sess())
    target = f"mem://{unique('sess')}"
    assert server.start(target) == 0
    try:
        ch = channel(pkg, target, timeout_ms=5000)
        answers = [call(pkg, ch)[1].message for _ in range(5)]
        assert answers == ["1", "2", "3", "4", "5"]
        assert len(made) == 1
        assert server._session_data_pool == made
        ch.close()
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_thread_local_data_per_worker_thread(pkg):
    seen = []

    class Tls(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            data = cntl.server.thread_local_data()
            seen.append((threading.get_ident(), id(data)))
            response.message = data["tag"]
            done()

    opts = pkg.rpc.ServerOptions()
    opts.thread_local_data_factory = lambda: {"tag": "tl"}
    server = pkg.rpc.Server(opts)
    server.add_service(Tls())
    target = f"mem://{unique('tls')}"
    assert server.start(target) == 0
    try:
        ch = channel(pkg, target, timeout_ms=5000)
        for _ in range(6):
            cntl, resp = call(pkg, ch)
            assert not cntl.failed() and resp.message == "tl"
        by_thread = {}
        for tid, did in seen:
            by_thread.setdefault(tid, set()).add(did)
        assert all(len(v) == 1 for v in by_thread.values())
        assert len({did for _, did in seen}) == len(by_thread)
        ch.close()
    finally:
        server.stop()
    no_factory = pkg.rpc.Server()
    assert no_factory.thread_local_data() is None


_ISO_SRC = ("def handle(payload):\n"
            "    return payload[::-1] + b'|iso'\n")


def test_register_isolated_answers_like_the_jax_pool():
    """An isolated method on the port's server answers over mem:// and
    ici:// what the JAX package's usercode pool answers for the same
    source and payload; "echo" returns the attachment, "drop" does not."""
    from brpc_tpu.rpc.usercode_pool import UsercodePool as JPool
    jpool = JPool(kind="auto", workers=1)
    try:
        jpool.register("Iso.Rev", _ISO_SRC)
        payload = EchoRequest(message="abc").SerializeToString()
        want = jpool.call_isolated("Iso.Rev", payload, timeout=30)
    finally:
        jpool.shutdown(wait=True)
    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          usercode_backup_threads=2))
    server.register_isolated("Iso.Rev", _ISO_SRC)
    server.register_isolated("Iso.Drop", _ISO_SRC, att="drop")
    target = f"mem://{unique('iso')}"
    assert server.start(target) == 0
    try:
        ch = channel(PORT, target, timeout_ms=30000, max_retry=0)
        for method, att_back in (("Iso.Rev", b"ATT"), ("Iso.Drop", b"")):
            cntl = rpc.Controller()
            cntl.request_attachment.append(b"ATT")
            got = ch.call_method(method, cntl, EchoRequest(message="abc"))
            assert not cntl.failed(), cntl.error_text
            assert got == want
            assert cntl.response_attachment.to_bytes() == att_back
        assert server.usercode_pool.describe()["isolated_calls"] >= 2
        ch.close()
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_register_isolated_requires_pool(pkg):
    srv = pkg.rpc.Server()
    srv.register_isolated("M.h", "def handle(p):\n    return p\n")
    with pytest.raises(ValueError):
        srv.start(f"mem://{unique('isoreq')}")
    with pytest.raises(ValueError):
        srv.register_isolated("M.x", "def handle(p):\n    return p\n",
                              att="keep")


# ---------------------------------------------------------------------
# the port on a CPU ici:// mesh: DEVICE attachments on the plane
# ---------------------------------------------------------------------

_PLANE_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
                "ici_device_plane_threshold")


@pytest.fixture()
def cpu_mesh():
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    saved = {n: tfl.get_flag(n) for n in _PLANE_FLAGS}
    tfl.set_flag("ici_device_plane", True)
    tfl.set_flag("ici_device_plane_host_mesh", True)
    tfl.set_flag("ici_device_plane_threshold", 1024)
    yield mesh
    for n, v in saved.items():
        tfl.set_flag(n, v)
    IciMesh.set_default(None)


def _plane_echo_server(rank, stall=None, native_ici=True):
    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            if stall is not None:
                stall(request)
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    # native_ici=False: the cancel and drop legs test the Python plane's
    # correlation-id semantics (the native plane runs a call to its end in
    # C and takes an injected drop as a spent deadline, as the reference's)
    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          usercode_backup_threads=4,
                                          native_ici=native_ici))
    server.add_service(Echo())
    assert server.start(f"ici://{rank}") == 0
    return server


def _payload(mesh, nbytes, rank, seed):
    data = np.random.default_rng(seed).integers(0, 256, nbytes,
                                                dtype=np.uint8)
    return mesh.device_put(torch.from_numpy(data), rank)


def test_backup_request_with_device_attachment(cpu_mesh):
    """Try 0 stalls at the server; the backup try answers first.  Both
    tries carry the attachment on the plane, the bytes come back exact,
    and the late answer is dropped."""
    tries = []

    def stall(request):
        tries.append(1)
        if len(tries) == 1:
            time.sleep(0.3)

    server = _plane_echo_server(3, stall)
    plane = dp.plane()
    payload = _payload(cpu_mesh, 8192, 1, seed=5)
    try:
        ch = channel(PORT, "ici://3", timeout_ms=5000, max_retry=1,
                     backup_request_ms=30)
        t0 = plane.stats()["transfers"]
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message="bk"), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "bk" and cntl.retried_count == 1
        assert cntl.response_attachment.to_bytes() == \
            bytes(payload.numpy())
        time.sleep(0.45)            # try 0 answers late, and is dropped
        assert len(tries) == 2
        # two requests and two answers crossed the plane
        assert plane.stats()["transfers"] - t0 == 4
        assert plane.active_transfers() == 0
        ch.close()
    finally:
        server.stop()


def test_cancel_with_device_attachment(cpu_mesh):
    """A call cancelled after its attachment crossed ends ECANCELED; the
    handler's late answer crosses back and is dropped."""
    entered = threading.Event()

    def stall(request):
        entered.set()
        time.sleep(0.3)

    server = _plane_echo_server(4, stall, native_ici=False)
    plane = dp.plane()
    payload = _payload(cpu_mesh, 8192, 1, seed=6)
    try:
        ch = channel(PORT, "ici://4", timeout_ms=5000, max_retry=0)
        t0 = plane.stats()["transfers"]
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        done = threading.Event()
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="c"),
                       EchoResponse, lambda c: done.set())
        assert entered.wait(5)
        assert plane.stats()["transfers"] - t0 == 1   # the request crossed
        cntl.cancel()
        assert done.wait(5)
        assert cntl.error_code == errors.ECANCELED
        time.sleep(0.45)
        assert cntl.error_code == errors.ECANCELED
        assert cntl._peek_response_attachment() is None
        assert plane.stats()["transfers"] - t0 == 2   # the late answer too
        assert plane.active_transfers() == 0
        ch.close()
    finally:
        server.stop()


def test_dropped_device_frame_posts_no_transfer(cpu_mesh):
    """A dropped request frame never reaches the transport: the plane's
    posted sends and active set stay as they were.  With seeded drops and
    timeout hedging every call answers, each crossing on the plane."""
    server = _plane_echo_server(5, native_ici=False)
    plane = dp.plane()
    payload = _payload(cpu_mesh, 4096, 1, seed=7)
    try:
        # ten tries a call: a try fails when its request or its answer
        # drops (half the time), so all ten fail one call in a thousand
        ch = channel(PORT, "ici://5", timeout_ms=3000, max_retry=9,
                     retry_on_timeout=True)
        pending0, active0 = len(plane._pending), set(plane._active)
        t0 = plane.stats()["transfers"]
        with tfi.inject(tfi.FaultInjector(drop_ratio=1.0)) as inj:
            cntl = rpc.Controller()
            cntl.max_retry = 0
            cntl.timeout_ms = 100
            cntl.request_attachment.append_device_array(payload)
            ch.call_method("EchoService.Echo", cntl,
                           EchoRequest(message="x"), EchoResponse)
            assert cntl.error_code == errors.ERPCTIMEDOUT
            assert inj.injected["drop"] == 1
        assert len(plane._pending) == pending0
        assert plane._active == active0
        assert plane.stats()["transfers"] == t0
        tries = 0
        with tfi.inject(tfi.FaultInjector(drop_ratio=0.3, seed=11)) as inj:
            for i in range(12):
                cntl = rpc.Controller()
                cntl.request_attachment.append_device_array(payload)
                resp = ch.call_method("EchoService.Echo", cntl,
                                      EchoRequest(message=str(i)),
                                      EchoResponse)
                assert not cntl.failed(), cntl.error_text
                assert resp.message == str(i)
                assert cntl.response_attachment.to_bytes() == \
                    bytes(payload.numpy())
                tries += cntl.retried_count + 1
        assert inj.injected["drop"] > 0 and tries > 12
        assert plane.active_transfers() == 0
        assert not plane._pending
        ch.close()
    finally:
        server.stop()
