"""Request-context inheritance and the shed retry in the port, held against
the JAX package on the CPU.

  * The cases of the JAX package's ``tests/test_request_context.py``:
    the scope units run on both ``request_context`` modules side by side
    and must agree; the two-hop cases (A -> B -> C over ``mem://``) run the
    same services on both stacks, and the leaf must see the same
    inherited priority and tenant and a budget decremented by B's work
    on both — an explicit override wins, inheritance beats channel
    defaults, and a spent budget fails the sub-call with
    ``ERPCTIMEDOUT`` before anything is sent, sync and async.
  * The client leg of ``tests/test_admission.py``: an ``ELIMIT`` shed with
    a ``retry_after_ms`` hint is retried no earlier than the hint (jitter
    only above it, the same draw as the JAX package's), and a hint past
    the overall deadline loses to ``ERPCTIMEDOUT``.  The port has no
    admission queue, so a handler sheds with the hint on both stacks.
  * The serving stack: a Generate's priority and tenant reach the decode
    pool through Prefill and LoadKv with no hand copies, and a client
    budget that runs out while Decode waits in the batch queue sheds
    there (``deadline_expired``).
"""
import json
import threading
import time
import types

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu import rpc as jrpc
from brpc_tpu.rpc import admission as jadmission
from brpc_tpu.rpc import request_context as jreqctx
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import admission as tadmission
from brpc_tpu_torch.rpc import request_context as treqctx
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import (EchoRequest as JEchoRequest,
                            EchoResponse as JEchoResponse)

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, reqctx=jreqctx,
                            Req=JEchoRequest, Resp=JEchoResponse,
                            inline=True)
# the port's handlers that make nested sync calls stay off the
# delivering thread
PORT = types.SimpleNamespace(name="port", rpc=rpc, reqctx=treqctx,
                             Req=EchoRequest, Resp=EchoResponse,
                             inline=False)


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server here is stopped by its test; at teardown the port's
    RPC pools must be empty too."""
    yield
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


# ---- scope units: both modules, side by side ---------------------------

def _cntl(pkg, priority=None, tenant="", deadline=0):
    c = pkg.rpc.Controller()
    if priority is not None:
        c.priority = priority
    if tenant:
        c.tenant = tenant
    if deadline:
        c.deadline_left_ms = deadline
    return c


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_scope_installs_and_restores(pkg):
    assert pkg.reqctx.current() is None
    with pkg.reqctx.scope(_cntl(pkg, priority=1, tenant="t")):
        ctx = pkg.reqctx.current()
        assert (ctx.priority, ctx.tenant) == (1, "t")
    assert pkg.reqctx.current() is None


def test_no_metadata_installs_no_context():
    for pkg in (JAX, PORT):
        with pkg.reqctx.scope(_cntl(pkg)):
            assert pkg.reqctx.current() is None


def test_nested_scope_shadows_then_restores():
    for pkg in (JAX, PORT):
        with pkg.reqctx.scope(_cntl(pkg, priority=0)):
            outer = pkg.reqctx.current()
            with pkg.reqctx.scope(_cntl(pkg, priority=3)):
                assert pkg.reqctx.current().priority == 3
            assert pkg.reqctx.current() is outer


def test_residual_deadline_decrements_with_elapsed_time():
    with jreqctx.scope(_cntl(JAX, deadline=100)), \
            treqctx.scope(_cntl(PORT, deadline=100)):
        j, t = jreqctx.current(), treqctx.current()
        r0 = (j.residual_deadline_ms(), t.residual_deadline_ms())
        assert all(r is not None and r <= 100 for r in r0)
        time.sleep(0.05)
        r1 = (j.residual_deadline_ms(), t.residual_deadline_ms())
        for a, b in zip(r0, r1):
            assert b < a and b <= 100 - 45


def test_no_deadline_means_no_residual():
    for pkg in (JAX, PORT):
        with pkg.reqctx.scope(_cntl(pkg, priority=2)):
            assert pkg.reqctx.current().residual_deadline_ms() is None


def test_scope_is_thread_local():
    seen = {}
    for pkg in (JAX, PORT):
        with pkg.reqctx.scope(_cntl(pkg, priority=1)):
            t = threading.Thread(
                target=lambda: seen.__setitem__(pkg.name,
                                                pkg.reqctx.current()))
            t.start()
            t.join()
    assert seen == {"jax": None, "port": None}


# ---- two hops over mem://, on both stacks ------------------------------

def _start(pkg, name, service):
    opts = pkg.rpc.ServerOptions()
    opts.usercode_inline = pkg.inline
    s = pkg.rpc.Server(opts)
    s.add_service(service)
    assert s.start(f"mem://{name}") == 0
    return s


def _two_hop(pkg, tag, mid_body, leaf_seen, *, cntl_setup,
             channel_options=None):
    """A calls B.Mid; B's handler runs ``mid_body(pkg, ch_to_c, seen)``
    against C.Leaf.  Returns (A's controller, what C and B saw) once B's
    handler has finished, which may be after A's call timed out."""
    seen = {}
    mid_done = threading.Event()

    class CService(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Leaf(self, cntl, request, response, done):
            leaf_seen.append(1)
            seen["priority"] = cntl.priority
            seen["tenant"] = cntl.tenant
            seen["deadline_left_ms"] = cntl.deadline_left_ms
            response.message = "leaf"
            done()

    cname = f"reqctx-{pkg.name}-{tag}-c"

    class BService(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Mid(self, cntl, request, response, done):
            ch = pkg.rpc.Channel()
            if channel_options is not None:
                ch.init(f"mem://{cname}",
                        options=channel_options(pkg.rpc))
            else:
                ch.init(f"mem://{cname}")
            try:
                mid_body(pkg, ch, seen)
            finally:
                ch.close()
                mid_done.set()
            response.message = "mid"
            done()

    sc = _start(pkg, cname, CService())
    sb = _start(pkg, f"reqctx-{pkg.name}-{tag}-b", BService())
    try:
        ch = pkg.rpc.Channel()
        ch.init(f"mem://reqctx-{pkg.name}-{tag}-b")
        cntl = pkg.rpc.Controller()
        cntl_setup(cntl)
        ch.call_method("BService.Mid", cntl, pkg.Req(message="x"), pkg.Resp)
        assert mid_done.wait(10), "B's handler never finished"
        ch.close()
        return cntl, seen
    finally:
        sb.stop()
        sc.stop()


def _sync_leaf(pkg, ch, seen, sub_setup=None):
    sub = pkg.rpc.Controller()
    if sub_setup is not None:
        sub_setup(sub)
    ch.call_method("CService.Leaf", sub, pkg.Req(message="x"), pkg.Resp)
    seen["sub_failed"] = sub.failed()
    seen["sub_code"] = sub.error_code_
    seen["sub_timeout_ms"] = sub.timeout_ms


def test_priority_tenant_and_deadline_inherit_across_two_hops():
    def mid(pkg, ch, seen):
        time.sleep(0.05)             # burn a slice of the budget first
        _sync_leaf(pkg, ch, seen)

    def setup(c):
        c.priority, c.tenant, c.timeout_ms = 0, "gold", 2000

    got = {}
    for pkg in (JAX, PORT):
        cntl, seen = _two_hop(pkg, "inherit", mid, [], cntl_setup=setup)
        assert not cntl.failed(), cntl.error_text
        assert not seen["sub_failed"]
        # C saw A's class, and a budget shrunk by B's 50 ms
        assert 0 < seen["deadline_left_ms"] <= 2000 - 40, seen
        assert seen["sub_timeout_ms"] <= 2000 - 40, seen
        got[pkg.name] = (seen["priority"], seen["tenant"])
    assert got["jax"] == got["port"] == (0, "gold")


def test_explicit_override_beats_inheritance():
    def mid(pkg, ch, seen):
        def override(sub):
            sub.priority, sub.tenant = 3, "scrap"
        _sync_leaf(pkg, ch, seen, override)

    def setup(c):
        c.priority, c.tenant = 0, "gold"

    got = {}
    for pkg in (JAX, PORT):
        cntl, seen = _two_hop(pkg, "override", mid, [], cntl_setup=setup)
        assert not cntl.failed() and not seen["sub_failed"]
        got[pkg.name] = (seen["priority"], seen["tenant"])
    assert got["jax"] == got["port"] == (3, "scrap")


def test_inherited_beats_channel_defaults():
    def setup(c):
        c.priority, c.tenant = 0, "gold"

    got = {}
    for pkg in (JAX, PORT):
        cntl, seen = _two_hop(
            pkg, "chdefaults", _sync_leaf, [], cntl_setup=setup,
            channel_options=lambda r: r.ChannelOptions(priority=3,
                                                       tenant="bulkload"))
        assert not cntl.failed() and not seen["sub_failed"]
        got[pkg.name] = (seen["priority"], seen["tenant"])
    assert got["jax"] == got["port"] == (0, "gold")


def test_channel_defaults_apply_outside_a_handler():
    """No inbound context: the channel-wide defaults fill the call."""
    seen = {}

    class Leaf(rpc.Service):
        SERVICE_NAME = "CService"

        @rpc.method(EchoRequest, EchoResponse)
        def Leaf(self, cntl, request, response, done):
            seen["got"] = (cntl.priority, cntl.tenant)
            done()

    s = _start(PORT, "reqctx-port-defaults", Leaf())
    try:
        ch = rpc.Channel()
        ch.init("mem://reqctx-port-defaults",
                options=rpc.ChannelOptions(priority=3, tenant="bulkload"))
        cntl = rpc.Controller()
        ch.call_method("CService.Leaf", cntl, EchoRequest(message="x"),
                       EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert seen["got"] == (3, "bulkload")
        ch.close()
    finally:
        s.stop()


def test_spent_budget_fails_subcall_before_any_work():
    def mid(pkg, ch, seen):
        time.sleep(0.08)             # burn past the inbound budget
        _sync_leaf(pkg, ch, seen)

    def setup(c):
        c.timeout_ms = 50

    for pkg in (JAX, PORT):
        leaf_ran = []
        _, seen = _two_hop(pkg, "spent", mid, leaf_ran, cntl_setup=setup)
        # the sub-call failed fast with the deadline code, never sent
        assert seen["sub_failed"]
        assert seen["sub_code"] == pkg.rpc.errors.ERPCTIMEDOUT
        assert not leaf_ran, f"{pkg.name}: dispatched on a spent budget"


def test_async_done_sees_failed_subcall_on_spent_budget():
    def mid(pkg, ch, seen):
        time.sleep(0.08)
        sub = pkg.rpc.Controller()
        evt = threading.Event()

        def sub_done(c):
            seen.setdefault("fired", []).append(c.error_code_)
            evt.set()
        ch.call_method("CService.Leaf", sub, pkg.Req(message="x"),
                       pkg.Resp, done=sub_done)
        assert evt.wait(2), "async done never fired"

    def setup(c):
        c.timeout_ms = 50

    fired = {}
    for pkg in (JAX, PORT):
        leaf_ran = []
        _, seen = _two_hop(pkg, "spentasync", mid, leaf_ran,
                           cntl_setup=setup)
        fired[pkg.name] = seen["fired"]
        assert not leaf_ran
    assert fired["jax"] == fired["port"] == [rpc.errors.ERPCTIMEDOUT]


# ---- the shed retry ------------------------------------------------------

def test_shed_backoff_is_the_jax_draw_and_never_below_the_hint():
    for hint in (1, 20, 100, 2000):
        for seed in ((7 << 8) ^ 1, (12345 << 8) ^ 3, None):
            t = tadmission.shed_backoff_s(hint, seed=seed)
            assert hint / 1000.0 <= t <= hint * 1.25 / 1000.0
            if seed is not None:
                assert t == jadmission.shed_backoff_s(hint, seed=seed)


def _shedding_server(pkg, name, hint_ms):
    """A handler that sheds ELIMIT with ``hint_ms`` until its gate opens;
    records each arrival's time."""
    gate = threading.Event()
    arrivals = []

    class Echo(pkg.rpc.Service):
        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            arrivals.append(time.monotonic())
            if not gate.is_set():
                cntl.retry_after_ms = hint_ms
                cntl.set_failed(pkg.rpc.errors.ELIMIT, "shed: backlog")
                done()
                return
            response.message = "ok"
            done()

    if pkg is JAX:
        # the JAX package's wire retry is on its socket planes (its mem://
        # loopback fast path completes in place): a localhost port, as its
        # own admission tests use
        server = pkg.rpc.Server()
        server.add_service(Echo())
        assert server.start("127.0.0.1:0") == 0
        return server, f"127.0.0.1:{server.listen_port}", gate, arrivals
    server = _start(pkg, name, Echo())
    return server, f"mem://{name}", gate, arrivals


@pytest.fixture()
def port_wire_plane():
    """The port's mem:// calls ride its socket plane, as the JAX legs ride
    a localhost port: both packages' loopback planes complete a shed in
    place, with no retry (restored after)."""
    from brpc_tpu_torch.butil import flags as tflags
    old = tflags.get_flag("mem_loopback_fast")
    tflags.set_flag("mem_loopback_fast", False)
    yield
    tflags.set_flag("mem_loopback_fast", old)


def test_retry_waits_for_hint_then_succeeds(port_wire_plane):
    """A shed call is not re-dispatched before the server's hint: the
    retry lands at least retry_after_ms after the shed and succeeds once
    the server takes it (the gate opens well BEFORE the hint elapses, so
    an early re-dispatch would succeed too soon)."""
    out = {}
    for pkg in (JAX, PORT):
        server, addr, gate, arrivals = _shedding_server(
            pkg, f"shed-hint-{pkg.name}", 100)
        ch = pkg.rpc.Channel()
        ch.init(addr,
                options=pkg.rpc.ChannelOptions(timeout_ms=4000, max_retry=3))
        opener = threading.Timer(0.05, gate.set)
        try:
            c = pkg.rpc.Controller()
            opener.start()
            t0 = time.monotonic()
            r = ch.call_method("Echo.Echo", c, pkg.Req(message="x"),
                               pkg.Resp)
            dt = time.monotonic() - t0
            assert c.error_code_ == 0 and r.message == "ok", c.error_text
            assert c.retried_count >= 1
            assert dt >= 0.1, dt
            assert arrivals[1] - arrivals[0] >= 0.1, arrivals
            out[pkg.name] = (c.retried_count, len(arrivals))
        finally:
            opener.cancel()
            gate.set()
            ch.close()
            server.stop()
    assert out["jax"] == out["port"] == (1, 2)


def test_retry_bounded_by_overall_deadline(port_wire_plane):
    """A hint longer than the remaining budget loses to ERPCTIMEDOUT: the
    deadline, not the hint, bounds the call, and no retry is sent."""
    for pkg in (JAX, PORT):
        server, addr, gate, arrivals = _shedding_server(
            pkg, f"shed-deadline-{pkg.name}", 2000)
        ch = pkg.rpc.Channel()
        ch.init(addr,
                options=pkg.rpc.ChannelOptions(timeout_ms=300, max_retry=3))
        try:
            c = pkg.rpc.Controller()
            t0 = time.monotonic()
            ch.call_method("Echo.Echo", c, pkg.Req(message="x"), pkg.Resp)
            dt = time.monotonic() - t0
            assert c.error_code_ == pkg.rpc.errors.ERPCTIMEDOUT, pkg.name
            assert dt < 1.5, dt          # not the 2 s hint: the deadline
        finally:
            gate.set()
            ch.close()
            server.stop()
        if pkg is PORT:
            # the delayed retry found the call ended and sent nothing
            time.sleep(2.6)
            assert len(arrivals) == 1, arrivals


def test_shed_without_hint_or_tries_is_final():
    """ELIMIT without a hint is not retried, nor is one with no tries
    left: both fail at once with the shed's code and hint."""
    server, _, gate, arrivals = _shedding_server(PORT, "shed-final", 30)
    try:
        ch = rpc.Channel()
        ch.init("mem://shed-final",
                options=rpc.ChannelOptions(timeout_ms=4000, max_retry=0))
        c = rpc.Controller()
        ch.call_method("Echo.Echo", c, EchoRequest(message="x"),
                       EchoResponse)
        assert c.error_code_ == rpc.errors.ELIMIT
        assert c.retry_after_ms == 30 and c.retried_count == 0
        assert len(arrivals) == 1
        ch.close()
    finally:
        gate.set()
        server.stop()


# ---- the serving stack ---------------------------------------------------

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")


@pytest.fixture
def manual_stack():
    """Prefill on ici://1, one decode worker on ici://2 whose scheduler is
    stepped by hand, the router on mem://, on a CPU mesh with the plane
    engaged."""
    from brpc_tpu_torch.butil import flags as fl
    from brpc_tpu_torch.examples.disagg_serving.model import VOCAB
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        close_services, start_decode_worker, start_prefill_worker,
        start_router)
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.serving import BatchSchedulerOptions
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    saved = {n: fl.get_flag(n) for n in _FLAGS}
    fl.set_flag("ici_device_plane", True)
    fl.set_flag("ici_device_plane_host_mesh", True)
    fl.set_flag("ici_device_plane_threshold", 64 * 1024)
    prefill = start_prefill_worker("ici://1")
    decode = start_decode_worker(
        "ici://2", sched_options=BatchSchedulerOptions(
            vocab=VOCAB, max_batch=8, auto_start=False))
    router = start_router("mem://reqctx-serving", "ici://1", ["ici://2"])
    svc = next(iter(decode.services().values()))
    try:
        yield svc
    finally:
        close_services(router, prefill, decode)
        for n, v in saved.items():
            fl.set_flag(n, v)
        IciMesh.set_default(None)


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _async_generate(tokens, steps, setup, **extra):
    ch = rpc.Channel()
    ch.init("mem://reqctx-serving", options=rpc.ChannelOptions(max_retry=0))
    cntl = rpc.Controller()
    setup(cntl)
    ended = threading.Event()
    ch.call_method("Router.Generate", cntl, EchoRequest(
        message=json.dumps({"tokens": tokens, "steps": steps, **extra})),
        EchoResponse, done=lambda c: ended.set())
    return ch, cntl, ended


def test_generate_context_reaches_the_decode_pool(manual_stack):
    """Router -> Prefill -> LoadKv -> Decode carry the client's priority
    and tenant with no hand copies: the session lands in the pool under
    them, and the queued Decode holds the client's budget."""
    from examples.disagg_serving import model as jmodel
    svc = manual_stack
    tokens = np.random.default_rng(3).integers(0, jmodel.VOCAB, 96).tolist()

    def setup(c):
        c.priority, c.tenant, c.timeout_ms = 1, "gold", 20000

    t0_us = time.monotonic_ns() // 1000
    ch, cntl, ended = _async_generate(tokens, 4, setup, release=False)
    try:
        assert _wait(lambda: svc.scheduler.queued() == 1)
        s = svc.pool.get("s1")
        assert (s.tenant, s.priority) == ("gold", 1)
        req = next(r for band in svc.scheduler._pending for r in band)
        assert (req.priority, req.tenant) == (1, "gold")
        # the client's 20 s budget, not the router channel's 60 s: each
        # hop sends what is left at send time, so the decode-side deadline
        # trails by the hops' transit, never by tens of seconds
        assert t0_us + 10 ** 7 < req.deadline_us < t0_us + 3 * 10 ** 7
        while not ended.is_set():
            svc.scheduler.step_once()
            time.sleep(0.005)
        assert not cntl.failed(), cntl.error_text
        got = json.loads(cntl.response.message)["tokens"]
        assert got == jmodel.reference_generate(tokens, 4)
    finally:
        ch.close()


def test_generate_budget_expires_in_decode(manual_stack):
    """A client budget that runs out while Decode waits in the batch
    queue: the Decode carries the client's residual budget (not the
    router channel's 60 s), so the next step sheds it as
    ``deadline_expired``, and the client sees ERPCTIMEDOUT."""
    from examples.disagg_serving import model as jmodel
    svc = manual_stack
    tokens = np.random.default_rng(4).integers(0, jmodel.VOCAB, 64).tolist()
    expired0 = svc.scheduler.describe()["deadline_expired"]
    ch, cntl, ended = _async_generate(
        tokens, 4, lambda c: setattr(c, "timeout_ms", 1500))
    try:
        assert _wait(lambda: svc.scheduler.queued() == 1)
        req = next(r for band in svc.scheduler._pending for r in band)
        wait_s = (req.deadline_us - time.monotonic_ns() // 1000) / 1e6
        assert wait_s < 1.5
        time.sleep(max(wait_s, 0) + 0.05)
        svc.scheduler.step_once()
        assert svc.scheduler.describe()["deadline_expired"] == expired0 + 1
        assert ended.wait(10)
        assert cntl.error_code_ == rpc.errors.ERPCTIMEDOUT
    finally:
        ch.close()
