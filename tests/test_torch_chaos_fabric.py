"""``tests/test_chaos_fabric.py``'s contracts on the port: the map of its 29
tests to their counterparts, and the ones that had none.

The map (JAX test, line -> the port's test):

  TestNativeChaosABI
    test_sever_after_bytes_truncates_mid_writev :144 -> here, both
        libraries over TCP (test_torch_bulk.py::
        test_chaos_modes_and_refused_handshake holds the UDS leg)
    test_drop_and_delay_frames :178 -> here, both libraries over TCP
    test_listener_refuses_next_handshake :213 -> here, both libraries over
        TCP
  TestFaultPlanSemantics
    test_seeded_plans_reproduce_identical_decisions :244 ->
        test_torch_fault_plan.py::test_seeded_plans_reproduce_the_jax_decisions
    test_inject_fabric_scopes_and_restores :253 ->
        test_torch_fault_plan.py::test_inject_fabric_scopes_and_restores
    test_match_scopes_plan_to_sockets :264 ->
        test_torch_fault_plan.py::test_match_scopes_plan_to_sockets
    test_refusal_budgets_are_exact :273 ->
        test_torch_fault_plan.py::test_refusal_budgets_are_exact_and_equal_jax
    test_plane_scoped_budgets_are_exact :281 -> here, both packages, with
        ``xfer_refuse_stages``
  TestStreamClaimFailure
    test_claim_failure_fails_stream_and_degrades_not_socket :308 -> here,
        on the port's stream module
  TestRevivalUnits
    test_health_check_backoff_doubles_with_bounded_jitter :365 -> here
        (the port seeds the jitter from the endpoint, as the JAX package
        does when no seed is given)
    test_breaker_isolation_gates_single_endpoint_channel :398 -> here
    test_retry_backoff_is_exponential_capped_and_deterministic :442 ->
        here
  TestPlaneHealthChaosMatrix
    test_prober_policy_kill_then_handshake_revival :483 -> here, both
        packages (test_torch_bulk.py::
        test_threaded_prober_transitions_and_counters_equal_jax holds the
        counters' parity)
    test_timer_policy_blackhole_latch_lapses_then_relatches :525 ->
        test_torch_plane_health.py::
        test_timer_policy_blackhole_latch_lapses_then_relatches
    test_epoch_policy_kill_gated_blackhole_timed :552 -> here;
        test_torch_plane_health.py holds each reason alone
    test_slow_never_degrades_any_policy :590 ->
        test_torch_fault_plan.py::test_slow_never_degrades_the_ports_planes
  two processes
    test_chaos_bulk_death_midstream_inline_fallback_then_revival :750 ->
        test_torch_bulk.py (same name)
    test_chaos_mid_writev_sever_fails_stream_cleanly_socket_survives :856
        -> test_torch_bulk.py (same name)
    test_chaos_lost_bulk_bytes_fail_stream_only :937 -> test_torch_bulk.py
    test_chaos_refused_bulk_reestablish_retries_with_backoff :1010 ->
        test_torch_bulk.py
    test_chaos_control_sever_fails_fast_then_revival_during_outage :1113 ->
        test_torch_fault_plan.py::
        test_control_sever_fails_fast_then_revival_during_outage
    test_chaos_peer_process_kill_fails_inflight_promptly :1174 ->
        test_torch_fault_plan.py::
        test_peer_killed_by_die_after_frames_fails_inflight_promptly
    test_chaos_device_plane_refusal_degrades_to_bulk_socket_survives :1265
        -> test_torch_bulk.py::
        test_chaos_device_plane_refusal_fails_einternal_nothing_on_bulk (the
        port's recorded difference: no host route for a refused post)
    test_chaos_drain_under_load_zero_client_failures :1477 -> here
    test_chaos_shm_plane_matrix_slow_kill_blackhole_zero_failures :1675 ->
        test_torch_bulk.py (same name)
    test_chaos_plane_handshake_parity_via_rpc_dump_goldens :1789 -> here,
        the trace read in both processes
  TestLiveMigrationChaos
    test_migration_chaos_matrix_zero_client_failures :1811 ->
        test_torch_migration.py's mem:// chaos soak

Besides, the host-delivered relocation (``brpc_tpu/ici/native_plane.py:
237-245``): a kind-2 or kind-5 payload arrives as a CPU tensor over the
native receive buffer, a handler forwards it into an in-process native-door
call to a rank of its own, later payloads recycle the buffer, and the
callee still holds the first payload's bytes.

Every two-process scenario here runs its children under both runtime
layers of the debug tooling, as ``tests/test_chaos_fabric.py:47-115``
runs the JAX children: ``BRPC_TPU_DEBUG_LOCK_ORDER=1``,
``BRPC_TPU_DEBUG_CUSTODY=1`` and both report paths
(``tests/torch_census.py``'s ``debug_layers``), and the fixture asserts
each child's reports: no lock-order cycle, no long hold, no outstanding
custody hold, no unmatched strict release.
"""
from __future__ import annotations

import ctypes
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.ici import plane_health as jph
from brpc_tpu.ici import route as jroute
from brpc_tpu.rpc import fault_injection as jfi
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import native as tnative
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.ici import plane_health as tph
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import fault_injection as tfi

from tests.torch_procs import ok, run_procs
from tests.torch_census import debug_layers

u8p = ctypes.POINTER(ctypes.c_uint8)
JAX = types.SimpleNamespace(fi=jfi, ph=jph, route=jroute, name="jax")
PORT = types.SimpleNamespace(fi=tfi, ph=tph, route=troute, name="port")
BOTH_PKG = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


# ---- the native chaos entries, over TCP --------------------------------

class _Lib:
    def __init__(self, name):
        if name == "jax":
            from brpc_tpu.butil import native
            self.lib, self.prefix = native.load(), "brpc_tpu_"
        else:
            self.lib, self.prefix = tnative.load_fabric(), "brpc_tpu_torch_"
        assert self.lib is not None

    def __getattr__(self, short):
        return getattr(self.lib, self.prefix + short)


@pytest.fixture(params=["jax", "port"])
def fab(request):
    return _Lib(request.param)


def _tcp_pair(F, key):
    port = ctypes.c_int()
    uds = ctypes.create_string_buffer(108)
    lh = F.fab_listen(b"127.0.0.1", ctypes.byref(port), uds, 108)
    assert lh
    ch = F.fab_connect(b"127.0.0.1", port.value, key)
    sh = F.fab_accept(lh, key, 10_000_000)
    assert ch and sh
    return lh, ch, sh


def _recv(F, h, uuid, timeout_us):
    out, olen = u8p(), ctypes.c_uint64()
    rc = F.fab_recv(h, uuid, timeout_us, ctypes.byref(out),
                    ctypes.byref(olen))
    if rc == 0:
        F.fab_buf_release(h, out, olen.value)
    return rc, olen.value


def _close(F, lh, *hs):
    for h in hs:
        F.fab_conn_close(h)
    F.fab_listener_close(lh)


def test_sever_after_bytes_truncates_mid_writev(fab):
    """The write crossing the watermark puts a truncated frame on the
    wire: the peer's reader marks the conn dead and the claim fails fast
    (-2); a frame sent whole before the watermark stays claimable."""
    F = fab
    lh, ch, sh = _tcp_pair(F, b"sev")
    try:
        data = (ctypes.c_uint8 * 1000)(*([9] * 1000))
        assert F.fab_send(ch, 1, data, 1000) == 0
        assert F.fab_chaos(ch, tfi.CHAOS_SEVER_AFTER_OUT_BYTES, 1500) == 0
        assert F.fab_send(ch, 2, data, 1000) == -1
        assert F.fab_alive(ch) == 0
        assert _recv(F, sh, 1, 5_000_000) == (0, 1000)
        t0 = time.monotonic()
        assert _recv(F, sh, 2, 30_000_000)[0] == -2
        assert time.monotonic() - t0 < 5
    finally:
        _close(F, lh, ch, sh)


def test_drop_and_delay_frames(fab):
    F = fab
    lh, ch, sh = _tcp_pair(F, b"drop")
    try:
        data = (ctypes.c_uint8 * 64)(*([4] * 64))
        # one frame dropped; the conn stays alive
        assert F.fab_chaos(sh, tfi.CHAOS_DROP_FRAMES, 1) == 0
        assert F.fab_send(ch, 10, data, 64) == 0
        assert _recv(F, sh, 10, 200_000)[0] == -1
        assert F.fab_alive(sh) == 1
        assert F.fab_send(ch, 11, data, 64) == 0
        assert _recv(F, sh, 11, 5_000_000) == (0, 64)
        # a delayed park: claimable only after the latency
        assert F.fab_chaos(sh, tfi.CHAOS_DELAY_PARK_MS, 150) == 0
        assert F.fab_send(ch, 12, data, 64) == 0
        t0 = time.monotonic()
        assert _recv(F, sh, 12, 5_000_000) == (0, 64)
        assert time.monotonic() - t0 >= 0.1
        assert F.fab_chaos(sh, tfi.CHAOS_CLEAR, 0) == 0
    finally:
        _close(F, lh, ch, sh)


def test_listener_refuses_next_handshake(fab):
    F = fab
    port = ctypes.c_int()
    uds = ctypes.create_string_buffer(108)
    lh = F.fab_listen(b"127.0.0.1", ctypes.byref(port), uds, 108)
    try:
        assert F.fab_chaos_listener(lh, 1) == 0
        ch = F.fab_connect(b"127.0.0.1", port.value, b"x")
        assert ch                          # the TCP connect succeeds
        assert F.fab_accept(lh, b"x", 300_000) == 0
        # the budget is spent: the next handshake binds
        ch2 = F.fab_connect(b"127.0.0.1", port.value, b"y")
        sh2 = F.fab_accept(lh, b"y", 5_000_000)
        assert sh2
        for h in (ch, ch2, sh2):
            F.fab_conn_close(h)
    finally:
        F.fab_listener_close(lh)


# ---- the plan's plane-scoped budgets -----------------------------------

@BOTH_PKG
def test_plane_scoped_budgets_are_exact(pkg):
    """Announce drops and transfer-stage refusals are exact budgets; the
    slow injector delays only the planes it names and counts each."""
    plan = pkg.fi.FabricFaultPlan(collective_drop_announces=2,
                                  xfer_refuse_stages=1,
                                  plane_slow_ms={"shm": 20})
    assert plan.on_collective_announce()
    assert plan.on_collective_announce()
    assert not plan.on_collective_announce()
    assert plan.injected["coll_announce_drop"] == 2
    assert plan.on_xfer_stage() and not plan.on_xfer_stage()
    assert plan.injected["xfer"] == 1
    t0 = time.monotonic()
    plan.on_plane_op(None, "shm")
    assert time.monotonic() - t0 >= 0.02
    t0 = time.monotonic()
    plan.on_plane_op(None, "bulk")
    assert time.monotonic() - t0 < 0.02
    assert plan.injected["plane_slow"] == 1


# ---- a stream's claim that fails ---------------------------------------

def test_claim_failure_fails_stream_and_degrades_not_socket():
    """A descriptor whose bytes cannot be claimed fails that stream and
    degrades the bulk plane; the socket is not failed."""
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.proto import rpc_meta_pb2 as meta_pb
    from brpc_tpu_torch.rpc import stream as stream_mod

    events = {"degraded": 0, "set_failed": 0, "closed": []}

    class Handler(rpc.StreamInputHandler):
        def on_received_messages(self, sid, msgs):
            pass

        def on_closed(self, sid):
            events["closed"].append(sid)

    class Sock:
        failed = False
        is_server_side = True
        on_failed_callbacks = []

        def stream_bulk_claim(self, uuid, blen):
            raise ConnectionError("bulk conn dead")

        def bulk_plane_failed(self):
            events["degraded"] += 1

        def set_failed(self, *a, **k):
            events["set_failed"] += 1

        def write(self, *a, **k):
            return 0

    cntl = types.SimpleNamespace(accepted_stream_id=0)
    s = stream_mod.stream_accept(cntl, rpc.StreamOptions(handler=Handler()))
    sock = Sock()
    s.mark_connected(77, sock)
    meta = meta_pb.RpcMeta()
    ss = meta.stream_settings
    ss.stream_id = s.sid
    ss.remote_stream_id = 77
    ss.frame_type = stream_mod.FRAME_DATA_BULK
    stream_mod.on_stream_frame(
        meta, IOBuf(stream_mod._BULK_DESC.pack(0xDEAD, 4096)), sock)
    assert events["degraded"] == 1
    assert events["set_failed"] == 0
    deadline = time.monotonic() + 5
    while not events["closed"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert events["closed"] == [s.sid]


# ---- the revival units --------------------------------------------------

def test_health_check_backoff_doubles_with_bounded_jitter():
    from brpc_tpu_torch.rpc.health_check import HealthCheckTask
    t = HealthCheckTask(parse_endpoint("mem://tchaos-hc-unit"))
    try:
        delays = []
        for count in (0, 1, 2, 3, 10):
            t.probe_count = count
            delays.append(t.next_delay_s())
        # doubling to the cap, jitter within [1, 1 + 0.2)
        for d, base in zip(delays, (0.1, 0.2, 0.4, 0.8, 2.0)):
            assert base <= d < base * 1.2, delays
    finally:
        t.cancel()
    # seeded from the endpoint: two fresh tasks draw the same jitter
    t2 = HealthCheckTask(parse_endpoint("mem://tchaos-hc-same"))
    t3 = HealthCheckTask(parse_endpoint("mem://tchaos-hc-same"))
    try:
        t2.probe_count = t3.probe_count = 3
        assert [t2.next_delay_s() for _ in range(3)] == \
            [t3.next_delay_s() for _ in range(3)]
    finally:
        t2.cancel()
        t3.cancel()


def test_breaker_isolation_gates_single_endpoint_channel():
    """A tripped breaker fails the channel fast; mark_recovered (the
    health checker's revival) lifts the gate."""
    from brpc_tpu_torch.rpc.circuit_breaker import BreakerRegistry

    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

    server = rpc.Server()
    server.add_service(Echo())
    target = "mem://tchaos-breaker-gate"
    assert server.start(target) == 0
    breaker = BreakerRegistry.instance().breaker(parse_endpoint(target))
    ch = rpc.Channel()
    try:
        ch.init(target, options=rpc.ChannelOptions(timeout_ms=2000,
                                                   max_retry=0))
        for _ in range(30):
            breaker.on_call_end(errors.EFAILEDSOCKET)
        assert breaker.is_isolated()
        cntl = rpc.Controller()
        t0 = time.monotonic()
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="x"),
                       EchoResponse)
        assert cntl.failed()
        assert time.monotonic() - t0 < 1.0
        breaker.mark_recovered()
        cntl = rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message="back"), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "back"
    finally:
        breaker.mark_recovered()
        ch.close()
        server.stop()


def test_retry_backoff_is_exponential_capped_and_deterministic():
    c = rpc.Controller()
    c.retry_backoff_ms = 50
    c._cid = 12345 << 32
    delays = []
    for c.retried_count in (1, 2, 3, 10):
        delays.append(c._retry_backoff_s())
    for d, base in zip(delays, (0.050, 0.100, 0.200, 1.000)):
        assert base <= d <= base * 1.25, delays
    c2 = rpc.Controller()
    c2.retry_backoff_ms = 50
    c2._cid = 12345 << 32
    c2.retried_count = c.retried_count = 2
    assert c._retry_backoff_s() == c2._retry_backoff_s()
    c.retry_backoff_ms = 0
    assert c._retry_backoff_s() == 0.0


# ---- the plane-health engine's prober and epoch rows ---------------------

def _delta(pkg, name, before):
    after = pkg.route.plane_stats()
    return {ev: after.get(f"{name}_{ev}", 0) - before.get(f"{name}_{ev}", 0)
            for ev in ("down", "reprobe", "revived", "ramp")}


def _register(pkg, name, **policy):
    if pkg is PORT:
        return pkg.ph.register_plane(name, threading.Lock(), **policy)
    return pkg.ph.register_plane(name, **policy)


@BOTH_PKG
def test_prober_policy_kill_then_handshake_revival(pkg):
    """KILL under the threaded policy (the bulk and shm shape): the loop
    owns the comeback; one refused dial counts a reprobe without a
    revival, and the first verdict after the revival clears the ramp."""
    ph = pkg.ph
    name = f"tmx_prober_{pkg.name}"
    attached = threading.Event()
    box = {"probes": 0}

    def prober():
        box["probes"] += 1
        if box["probes"] < 2:
            return False
        box["rec"].revived()
        attached.set()
        return True

    rec = box["rec"] = _register(pkg, name, prober=prober,
                                 attached=attached.is_set,
                                 backoff_base=0.01, backoff_cap=0.02)
    before = pkg.route.plane_stats()
    assert rec.usable() is True
    assert rec.mark_down("chaos kill") is True
    assert rec.mark_down("chaos kill") is False
    assert rec.usable() is False
    rec.kick()
    assert attached.wait(10), "revival loop never attached"
    snap = rec.snapshot()
    assert snap["state"] == ph.UP and snap["half_open"], snap
    assert snap["downs"] == 1 and snap["revivals"] == 1, snap
    assert rec.usable() is True
    assert rec.snapshot()["half_open"] is False
    assert _delta(pkg, name, before) == \
        {"down": 1, "reprobe": 2, "revived": 1, "ramp": 1}
    deadline = time.monotonic() + 5
    while rec.running and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not rec.running and not rec.wanted


@BOTH_PKG
def test_epoch_policy_kill_gated_blackhole_timed(pkg):
    """One record through both rows: a membership death revives only when
    the epoch moves; a transient reason revives after its window under a
    stable epoch."""
    name = f"tmx_epoch_{pkg.name}"
    epoch = {"n": 7}
    rec = _register(pkg, name, epoch_fn=lambda: epoch["n"],
                    transient_reasons=("announce timeout",),
                    reprobe_s=lambda: 0.25)
    before = pkg.route.plane_stats()
    assert rec.mark_down("member dead") is True
    assert rec.snapshot()["down_epoch"] == 7
    assert rec.usable() is False
    time.sleep(0.3)
    assert rec.usable() is False, "a dead member revived by waiting"
    epoch["n"] = 8
    assert rec.usable() is True
    assert rec.usable() is True
    assert rec.mark_down("announce timeout") is True
    assert rec.usable() is False
    time.sleep(0.35)
    assert rec.usable() is True
    assert rec.usable() is True
    assert _delta(pkg, name, before) == \
        {"down": 2, "reprobe": 2, "revived": 2, "ramp": 2}


# ---- two processes -----------------------------------------------------

# :1789, read in both processes: a bulk kill, then a ring kill, on one
# socket; each side's trace holds one handshake a kill, in wire order, and
# the healthy echo wrote nothing
_PARITY = r"""
import tempfile
from brpc_tpu_torch.rpc import fault_injection as fi
from brpc_tpu_torch.rpc import rpc_dump
dump_dir = tempfile.mkdtemp(prefix="plane_trace_")
flags.set_flag("rpc_dump_dir", dump_dir)
flags.set_flag("rpc_dump", True)
CHUNK = 256 * 1024
out = {}

def wait_for(fn, t=30):
    end = time.time() + t
    while not fn() and time.time() < end:
        time.sleep(0.02)
    return fn()

# chaos_plane KILL, then wait until this end's reader saw it: the next
# frame's route probe here finds the plane dead, so this side sends DOWN,
# as in the JAX goldens
def kill(s, plane):
    with s._bulk_lock:
        h = s._bulk if plane == "bulk" else s._shm
        lib = s._blib if plane == "bulk" else s._shmlib
    alive = (lib.brpc_tpu_torch_fab_alive if plane == "bulk"
             else lib.brpc_tpu_torch_shm_alive)
    armed = fi.chaos_plane(s, plane, fi.KILL)
    return armed and bool(wait_for(lambda: not alive(h), 30))

if pid == 0:
    class EchoSvc(rpc.Service):
        SERVICE_NAME = "EchoSvc"
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = "srv:" + request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()
    server = rpc.Server(rpc.ServerOptions(native_ici=False))
    server.add_service(EchoSvc())
    assert server.start("ici://0") == 0
    barrier("up")
    barrier("traced")               # the client still holds its channel
    out["socks"] = [s.id for s in fabric_socks() if s.is_server_side]
    barrier("done")
    server.stop()
else:
    barrier("up")
    payload = bytes(bytearray((i * 5 + 1) & 0xFF for i in range(CHUNK)))
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                  max_retry=0))
    errs = []

    def echo(tag):
        cntl = rpc.Controller()
        cntl.request_attachment.append(payload)
        ch.call_method("EchoSvc.Echo", cntl, EchoRequest(message=tag),
                       EchoResponse)
        if cntl.failed():
            errs.append((tag, cntl.error_code_, cntl.error_text))
        elif cntl.response_attachment.to_bytes() != payload:
            errs.append((tag, "corrupt"))

    echo("healthy")
    s = [x for x in fabric_socks() if not x.is_server_side][0]
    out["healthy_records"] = len(rpc_dump.load_fabric_trace(dump_dir))
    out["bound"] = [bool(s.shm_bound()), bool(s._bulk)]
    out["armed"] = [kill(s, "bulk")]
    echo("bulk-killed")
    out["bulk_revived"] = bool(wait_for(lambda: s.bulk_epoch() >= 2))
    out["armed"].append(kill(s, "shm"))
    echo("shm-killed")
    out["shm_revived"] = bool(wait_for(lambda: s.shm_epoch() >= 2))
    echo("both-revived")
    out["socks"] = [s.id]
    out["failed"] = s.failed
    out["errors"] = errs
    barrier("traced")
    barrier("done")
    ch.close()
out["trace"] = rpc_dump.load_fabric_trace(dump_dir)
out["foreign"] = foreign()
result(out)
finish()
"""

# :1477, the zero-downtime restart: LB traffic over two servers while one
# drains and restarts, a stream to it in flight and a posted device-plane
# transfer inside its grace window
_DRAIN = r"""
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.rpc import lameduck
flags.set_flag("ici_fabric_shm", False)
CHUNK = 128 * 1024
NFRAMES = 12
out = {}

def frame_for(seq):
    return b"%08d" % seq + bytes([(seq * 13 + 7) % 251]) * (CHUNK - 8)

if pid == 0:
    def make_server(tag, rank, state=None):
        class Echo(rpc.Service):
            SERVICE_NAME = "EchoService"
            @rpc.method(EchoRequest, EchoResponse)
            def Echo(self, cntl, request, response, done):
                response.message = tag + ":" + request.message
                done()
        s = rpc.Server(rpc.ServerOptions(native_ici=False))
        s.add_service(Echo())
        if state is not None:
            class Sink(rpc.StreamInputHandler):
                def on_received_messages(self, sid, msgs):
                    for m in msgs:
                        if m.to_bytes() != frame_for(state["next"]):
                            state["bad"].append(state["next"])
                        state["next"] += 1
                def on_closed(self, sid):
                    state["closed"].set()
            class StreamSvc(rpc.Service):
                SERVICE_NAME = "StreamSvc"
                @rpc.method(EchoRequest, EchoResponse)
                def Start(self, cntl, request, response, done):
                    rpc.stream_accept(cntl, rpc.StreamOptions(
                        handler=Sink(), max_buf_size=8 << 20))
                    response.message = "ok"
                    done()
            s.add_service(StreamSvc())
        assert s.start("ici://%d" % rank) == 0
        return s

    state = {"next": 0, "bad": [], "closed": threading.Event()}
    server_a = make_server("a", 0, state)
    server_b = make_server("b", 1)
    barrier("up")
    get("traffic_on")
    plane = dp.plane()
    arr = mesh.own(torch.zeros(256 * 1024, dtype=torch.uint8), 0)
    released = []
    t = plane.post_send(arr, 0, 1)
    t.add_source_release(lambda: released.append(1))
    threading.Timer(0.6, lambda: plane.post_recv(t.uuid)).start()
    t0 = time.monotonic()
    server_a.stop(15.0)
    dt = time.monotonic() - t0
    out["drain"] = {"state": t.state, "released": list(released),
                    "active": plane.active_transfers(),
                    "pending": plane.pending_sends(),
                    "closed": state["closed"].wait(5),
                    "frames": state["next"], "bad": state["bad"][:5],
                    "s": dt}
    put("drained", 1)
    released2 = []
    t2 = plane.post_send(arr, 0, 1)
    t2.add_source_release(lambda: released2.append(1))
    straggle = rpc.Server()
    assert straggle.start("mem://tchaos-straggle-%d" % os.getpid()) == 0
    straggle.stop(0.3)
    out["straggler"] = {"state": t2.state, "released": list(released2),
                        "pending": plane.pending_sends()}
    time.sleep(0.5)
    server_a2 = make_server("a2", 0)
    put("restarted", 1)
    barrier("done", 180)
    out["a2_served"] = any(m.latency_rec.count() > 0 for m in
                           server_a2._method_status.values())
    server_a2.stop()
    server_b.stop()
else:
    barrier("up")
    ch = rpc.Channel()
    ch.init("list://ici://0,ici://1", "rr",
            options=rpc.ChannelOptions(timeout_ms=10000, max_retry=3))
    failures = []
    seen = set()
    stop_traffic = threading.Event()

    def fire(i):
        cntl = rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message=str(i)), EchoResponse)
        if cntl.failed():
            failures.append((cntl.error_code_, cntl.error_text))
        else:
            seen.add(resp.message.split(":")[0])

    def traffic():
        i = 0
        while not stop_traffic.is_set():
            fire(i)
            i += 1
            time.sleep(0.01)

    for i in range(12):
        fire(i)
    out["warm"] = sorted(seen)
    sch = rpc.Channel()
    sch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                   max_retry=0))
    cntl = rpc.Controller()
    stream = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=8 << 20))
    sch.call_method("StreamSvc.Start", cntl, EchoRequest(message="s"),
                    EchoResponse)
    assert not cntl.failed(), cntl.error_text
    assert stream.wait_connected(10)
    s0 = [s for s in fabric_socks() if s.remote_dev == 0
          and not s.is_server_side][0]
    out["bulk_bound"] = bool(s0._bulk)
    threads = [threading.Thread(target=traffic) for _ in range(2)]
    for th in threads:
        th.start()
    rcs = []

    def stream_writer():
        for seq in range(NFRAMES):
            rcs.append(stream.write(IOBuf(frame_for(seq)), timeout=30))
            time.sleep(0.25)
        stream.close()

    sw = threading.Thread(target=stream_writer)
    sw.start()
    time.sleep(0.3)
    put("traffic_on", 1)
    ep0 = mesh.endpoint(0)
    deadline = time.time() + 20
    while not lameduck.is_draining(ep0) and time.time() < deadline:
        time.sleep(0.02)
    out["goodbye_seen"] = lameduck.is_draining(ep0)
    sw.join(60)
    out["writer_done"] = not sw.is_alive()
    out["stream_rcs"] = rcs
    out["bulk_bytes"] = s0.bulk_bytes_sent
    get("drained")
    get("restarted")
    deadline = time.time() + 30
    seen.clear()
    while "a2" not in seen and time.time() < deadline:
        time.sleep(0.05)
    stop_traffic.set()
    for th in threads:
        th.join(30)
    out["seen_after"] = sorted(seen)
    out["draining_after"] = lameduck.is_draining(ep0)
    out["failures"] = failures[:5]
    out["n_failures"] = len(failures)
    barrier("done", 180)
    sch.close()
    ch.close()
out["foreign"] = foreign()
result(out)
finish()
"""

# brpc_tpu/ici/native_plane.py:237-245: a host-delivered payload forwarded
# into an in-process native-door call, its buffer recycled under it
_RELOCATE = r"""
import hashlib
from brpc_tpu_torch.ici import native_plane
from brpc_tpu_torch.tools.overload_clients import attachment_tensor
KIND = "%(kind)s"
flags.set_flag("ici_fabric_shm", KIND == "shm")
flags.set_flag("ici_shm_stripes", 1)
flags.set_flag("ici_shm_ring_bytes", 1 << 20)
# DEVICE payloads the device plane does not carry: kind 5 on the ring,
# kind 2 on the bulk conn, delivered host-resident
flags.set_flag("ici_device_plane_threshold", 1 << 30)
N = 192 * 1024
LATER = 12
out = {}

def payload(i):
    g = torch.Generator().manual_seed(1000 + i)
    return torch.randint(0, 256, (N,), dtype=torch.uint8, generator=g)

if pid == 1:
    kept = []

    class Keep(rpc.Service):
        SERVICE_NAME = "Keep"
        @rpc.method(EchoRequest, EchoResponse)
        def Hold(self, cntl, request, response, done):
            t = attachment_tensor(cntl.request_attachment)
            kept.append(t)
            response.message = str(mesh.rank_of(t))
            done()

    callee = rpc.Server()             # the default door: native
    callee.add_service(Keep())
    assert callee.start("ici://3") == 0
    fwd = rpc.Channel()
    fwd.init("ici://3", options=rpc.ChannelOptions(timeout_ms=30000,
                                                   max_retry=0))
    seen = []

    class Fwd(rpc.Service):
        SERVICE_NAME = "Fwd"
        @rpc.method(EchoRequest, EchoResponse)
        def Take(self, cntl, request, response, done):
            t = attachment_tensor(cntl.request_attachment)
            info = {"device": str(t.device), "ptr": t.data_ptr(),
                    "rank_of": mesh.rank_of(t)}
            if request.message == "forward":
                r0 = native_plane.relocation_stats()
                c2 = rpc.Controller()
                c2.request_attachment.append_device_array(t)
                resp2 = fwd.call_method("Keep.Hold", c2,
                                        EchoRequest(message="k"),
                                        EchoResponse)
                r1 = native_plane.relocation_stats()
                info.update(forward_error=c2.error_text if c2.failed()
                            else None, callee_rank=resp2.message,
                            native=fwd._native_ici is not None,
                            relocated={k: r1[k] - r0[k] for k in r1})
            del t
            seen.append(info)
            response.message = "ok"
            done()

    server = rpc.Server(rpc.ServerOptions(native_ici=False,
                                          usercode_in_pthread=True))
    server.add_service(Fwd())
    assert server.start("ici://2") == 0
    barrier("up")
    barrier("sent")
    s = [x for x in fabric_socks() if x.is_server_side][0]
    out["claimed"] = {"shm": s.shm_bytes_claimed,
                      "bulk": s.bulk_bytes_claimed}
    out["seen"] = seen
    out["kept_equal"] = len(kept) == 1 and torch.equal(kept[0], payload(0))
    out["kept_rank"] = mesh.rank_of(kept[0]) if kept else None
    first = seen[0]["ptr"] if seen else None
    # a later payload landed over the first one's bytes
    out["recycled"] = first is not None and any(
        abs(x["ptr"] - first) < N for x in seen[1:])
    barrier("done")
    fwd.close()
    callee.stop()
    server.stop()
else:
    barrier("up")
    ch = rpc.Channel()
    ch.init("ici://2", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    errs = []
    for i in range(1 + LATER):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(mesh.own(payload(i), 0))
        ch.call_method("Fwd.Take", cntl, EchoRequest(
            message="forward" if i == 0 else "plain"), EchoResponse)
        if cntl.failed():
            errs.append((i, cntl.error_code_, cntl.error_text))
    out["errors"] = errs
    barrier("sent")
    barrier("done")
    ch.close()
out["foreign"] = foreign()
result(out)
finish()
"""


@pytest.fixture(scope="module")
def two_proc():
    scen = {"parity": _PARITY, "drain": _DRAIN,
            "relocate_shm": _RELOCATE % {"kind": "shm"},
            "relocate_bulk": _RELOCATE % {"kind": "bulk"}}
    # every child under both runtime layers, its reports asserted
    with debug_layers() as layers:
        with ThreadPoolExecutor(len(scen)) as ex:
            futs = {k: ex.submit(run_procs, layers.body(body, k), 2, 110)
                    for k, body in scen.items()}
            raw = {k: f.result() for k, f in futs.items()}
        res = {k: ok(rs) for k, rs in raw.items()}
        for k, rs in raw.items():
            assert len(layers.check(k, rs)) == 2
    for rs in res.values():
        for r in rs:
            assert r["foreign"] == []
    return res


def _family(trace, lo, direction):
    return [r for r in trace
            if r["dir"] == direction and lo <= r["ftype"] <= lo + 3]


def test_chaos_plane_handshake_parity_via_rpc_dump_traces(two_proc):
    """The JAX test's goldens on the port's wire: the client sends DOWN
    (empty) then REESTABLISH ({"bulk_key"} / {"shm_seg"}) and gets one
    empty OK, never an ERR; the server's trace is its mirror image; the
    healthy echo wrote no plane frame."""
    import json
    srv, cli = two_proc["parity"]
    assert cli["errors"] == [] and cli["failed"] is False, cli["errors"]
    assert cli["bound"] == [True, True] and cli["armed"] == [True, True]
    assert cli["bulk_revived"] and cli["shm_revived"]
    assert cli["healthy_records"] == 0
    for side, r in (("client", cli), ("server", srv)):
        trace = [x for x in r["trace"] if x["sock"] in r["socks"]]
        assert trace == r["trace"], (side, r["socks"], r["trace"])
        mine, theirs = ("out", "in") if side == "client" else ("in", "out")
        for lo, key in ((8, "bulk_key"), (17, "shm_seg")):
            req = _family(trace, lo, mine)
            assert [x["ftype"] for x in req] == [lo, lo + 1], (side, trace)
            assert req[0]["body"] == ""
            body = json.loads(bytes.fromhex(req[1]["body"]))
            assert set(body) == {key} and body[key], (side, body)
            okay = _family(trace, lo, theirs)
            assert [x["ftype"] for x in okay] == [lo + 2], (side, trace)
            assert okay[0]["body"] == ""
        order = [x["ftype"] for x in trace]
        assert order.index(8) < order.index(9) < order.index(10), order
        assert order.index(17) < order.index(18) < order.index(19), order


def test_chaos_drain_under_load_zero_client_failures(two_proc):
    srv, cli = two_proc["drain"]
    d = srv["drain"]
    assert d["state"] == "complete" and d["released"] == [1], d
    assert d["active"] == 0 and d["pending"] == 0, d
    assert d["closed"] and d["frames"] == 12 and d["bad"] == [], d
    assert d["s"] < 12.0, d
    st = srv["straggler"]
    assert st == {"state": "failed", "released": [1], "pending": 0}, st
    assert srv["a2_served"] is True
    assert cli["warm"] == ["a", "b"], cli["warm"]
    assert cli["bulk_bound"] is True
    assert cli["goodbye_seen"] is True
    assert cli["writer_done"] and cli["stream_rcs"] == [0] * 12, cli
    assert cli["bulk_bytes"] >= 12 * 128 * 1024, cli["bulk_bytes"]
    assert "a2" in cli["seen_after"], cli["seen_after"]
    assert cli["draining_after"] is False
    assert cli["n_failures"] == 0, cli["failures"]


@pytest.mark.parametrize("kind", ["shm", "bulk"])
def test_host_delivered_relocation_survives_buffer_recycling(two_proc,
                                                             kind):
    """Kind 5 (ring) and kind 2 (bulk conn): the payload arrives as a CPU
    tensor over the native buffer (no rank owns it: ``rank_of`` answers
    -1), is forwarded into a native-door call on its own process, which
    relocates it by ``device_put`` into a copy; later payloads recycle the
    buffer, and the callee still holds the first payload's bytes."""
    cli_side, srv = two_proc[f"relocate_{kind}"]
    assert cli_side["errors"] == [], cli_side["errors"]
    claimed = srv["claimed"]
    assert claimed[kind] >= 13 * 192 * 1024, claimed
    first = srv["seen"][0]
    assert first["device"] == "cpu" and first["rank_of"] == -1, first
    assert first["forward_error"] is None and first["native"], first
    assert first["callee_rank"] == "3", first
    assert first["relocated"]["device_put"] == 1, first["relocated"]
    assert first["relocated"]["plane"] == 0, first["relocated"]
    assert all(x["rank_of"] == -1 for x in srv["seen"])
    assert srv["recycled"], [x["ptr"] for x in srv["seen"]]
    assert srv["kept_equal"] is True and srv["kept_rank"] == 3
