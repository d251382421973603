"""Admission, limiters, method status and the circuit breaker of the port,
held against the JAX package on the CPU.

  * Parity: scripted inputs made from a numpy seed go through both
    packages' ``AdmissionController`` (submissions, pumps, releases,
    expiries and stops on a simulated clock, a fake gate),
    ``AutoConcurrencyLimiter`` (``add_sample`` sequences), the constant
    and timeout limiters, ``MethodStatus`` and ``CircuitBreaker``; every
    decision, counter and hint must agree exactly.
  * The controller-level cases of the JAX package's
    ``tests/test_admission.py`` run on both packages with the same
    expectations (strict bands and DRR, shed-before-queue, fair share,
    deadline shed, queue timeout, retry-after, rate EMA, fail_all, the
    residual-deadline bound, the rollback gate, the tenant cap, restore at
    the queue head, the mini-overload).
  * The server cases run on the port over ``mem://`` and over ``ici://``
    on a CPU mesh with the device plane engaged: plane shed semantics,
    the draining bounce of queued entries, the deadline shed on the wire,
    the gate reject that leaves no trace in the method status, the
    release pump that does not recurse, the client's retry after the
    hint, and sheds that do not trip the client's breaker.
"""
from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.policy import limiters as jlim
from brpc_tpu.rpc import admission as jadm
from brpc_tpu.rpc import circuit_breaker as jcb
from brpc_tpu.rpc import errors as jerrors
from brpc_tpu.rpc import method_status as jms
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import limiters as tlim
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import admission as tadm
from brpc_tpu_torch.rpc import circuit_breaker as tcb
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import method_status as tms
from brpc_tpu_torch.rpc.controller import server_controller_pool

JAX = types.SimpleNamespace(name="jax", adm=jadm, lim=jlim, ms=jms, cb=jcb,
                            errors=jerrors)
PORT = types.SimpleNamespace(name="port", adm=tadm, lim=tlim, ms=tms,
                             cb=tcb, errors=errors)
PKGS = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server and channel here is closed by its test: at teardown
    the port's sockets and pooled server Controllers are all returned."""
    yield
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


def test_error_codes_agree():
    for name in ("ELIMIT", "ELOGOFF", "ERPCTIMEDOUT", "EINTERNAL"):
        assert getattr(jerrors, name) == getattr(errors, name)


# ---------------------------------------------------------------------
# controller-level harness (simulated clock, fake gate)
# ---------------------------------------------------------------------

class _Gate:
    """A fake concurrency gate with explicit capacity."""

    def __init__(self, slots: int):
        self.slots = slots
        self.lock = threading.Lock()

    def try_enter(self) -> bool:
        with self.lock:
            if self.slots > 0:
                self.slots -= 1
                return True
            return False

    def release(self) -> None:
        with self.lock:
            self.slots += 1


def _mk_controller(pkg, gate, clock, *, dispatch_log=None, **opt_kw):
    opts = pkg.adm.AdmissionOptions(use_timers=False, **opt_kw)
    runs = dispatch_log if dispatch_log is not None else []
    return pkg.adm.AdmissionController(
        None, opts, now_us=lambda: clock[0],
        dispatch=lambda run, waited_us: (runs.append(waited_us),
                                         run(waited_us)))


def _submit(adm, gate, order, tag, pri, tenant, clock, deadline_ms=5000):
    adm.submit(priority=pri, tenant=tenant, deadline_left_ms=deadline_ms,
               recv_us=clock[0], try_enter=gate.try_enter,
               run=lambda w, t=tag: order.append(t),
               shed=lambda c, txt, ra, t=tag: order.append(
                   ("SHED", t, c, ra, txt)))


# ---- parity: one script, both packages --------------------------------

def _admission_script(seed: int):
    rng = np.random.default_rng(seed)
    opts = {
        "queue_capacity": int(rng.integers(4, 17)),
        "max_queue_ms": float(rng.choice([10.0, 25.0, 50.0])),
        "tenant_weights": {"a": int(rng.integers(1, 4)),
                           "b": int(rng.integers(1, 4))},
        "queueable_priority_max": int(rng.integers(0, 3)),
        "service_rate_override": float(rng.choice([0.0, 0.0, 80.0])),
    }
    ops = []
    for i in range(400):
        k = rng.random()
        if k < 0.45:
            deadline = (None if rng.random() < 0.3
                        else int(rng.integers(1, 120)))
            ops.append(("submit", f"r{i}", int(rng.choice([-1, 0, 0, 1, 3])),
                        str(rng.choice(["a", "b", "c", "d", ""])),
                        deadline, int(rng.integers(0, 40_000))))
        elif k < 0.6:
            ops.append(("advance", int(rng.integers(0, 15_000))))
        elif k < 0.7:
            ops.append(("slots", int(rng.integers(0, 4))))
        elif k < 0.8:
            ops.append(("release",))
        elif k < 0.87:
            ops.append(("pump",))
        elif k < 0.96:
            ops.append(("expire",))
        elif k < 0.97:
            ops.append(("fail_all",))
        else:
            ops.append(("reset",))
    return opts, ops


def _run_admission_script(pkg, opts, ops):
    clock = [1_000_000]
    gate = _Gate(1)
    log = []
    adm = _mk_controller(pkg, gate, clock, **opts)
    for op in ops:
        kind = op[0]
        if kind == "submit":
            _, tag, pri, tenant, deadline, age = op
            adm.submit(priority=None if pri < 0 else pri, tenant=tenant,
                       deadline_left_ms=deadline, recv_us=clock[0] - age,
                       try_enter=gate.try_enter,
                       run=lambda w, t=tag: log.append(("run", t, w)),
                       shed=lambda c, txt, ra, t=tag: log.append(
                           ("shed", t, c, ra, txt)))
        elif kind == "advance":
            clock[0] += op[1]
        elif kind == "slots":
            gate.slots = op[1]
        elif kind == "release":
            gate.release()
            adm.on_release()
        elif kind == "pump":
            log.append(("pumped", adm.pump()))
        elif kind == "expire":
            log.append(("expired", adm.expire_queued()))
        elif kind == "fail_all":
            log.append(("failed", adm.fail_all(pkg.errors.ELOGOFF,
                                               "server stopping")))
        else:
            adm.reset()
        log.append(("state", adm.queued(), adm.retry_after_ms(),
                    adm.service_rate()))
    return log, adm.describe()


@pytest.mark.parametrize("seed", range(6))
def test_admission_parity_scripted(seed):
    opts, ops = _admission_script(seed)
    jlog, jdesc = _run_admission_script(JAX, opts, ops)
    tlog, tdesc = _run_admission_script(PORT, opts, ops)
    assert tlog == jlog
    assert tdesc == jdesc
    # the script exercised every outcome
    kinds = {e[0] for e in tlog}
    assert {"run", "shed"} <= kinds
    assert tdesc["shed"] > 0 and tdesc["admitted_from_queue"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_auto_limiter_parity_after_every_window(seed):
    rng = np.random.default_rng(100 + seed)
    lims = [pkg.lim.AutoConcurrencyLimiter(
        initial=40, sample_window_us=20_000, min_sample_count=10,
        max_sample_count=60, remeasure_interval_us=20_000)
        for pkg in (JAX, PORT)]
    now = 1_000_000
    base = 800 + 400 * seed
    seen = []
    for i in range(3000):
        now += int(rng.integers(10, 40))     # ~40k qps: concurrency ~40
        # latency grows with a slow load wave, errors are rare
        load = 1.0 + 0.8 * np.sin(i / 300.0) ** 2
        lat = int(base * load + rng.integers(0, 200))
        code = int(jerrors.EINTERNAL) if rng.random() < 0.05 else 0
        for lim in lims:
            lim.add_sample(code, lat, now)
        seen.append(tuple((lim.max_concurrency(), lim.min_latency_us,
                           lim.max_qps, lim.remeasure_count)
                          for lim in lims))
    assert all(j == t for j, t in seen)
    # the windows closed, moved the limit and ran the exploration
    assert len({j[0] for j, _ in seen}) > 3
    assert lims[1].remeasure_count >= 2


def test_auto_limiter_all_error_window_halves():
    for pkg in (JAX, PORT):
        lim = pkg.lim.AutoConcurrencyLimiter(
            initial=40, sample_window_us=1000, min_sample_count=4)
        for i in range(5):
            lim.add_sample(pkg.errors.EINTERNAL, 100, 10_000 + 500 * i)
        assert lim.max_concurrency() == 20


def test_constant_and_timeout_limiter_parity():
    rng = np.random.default_rng(7)
    pairs = [(pkg.lim.ConstantConcurrencyLimiter(5),
              pkg.lim.TimeoutConcurrencyLimiter(timeout_ms=20.0))
             for pkg in (JAX, PORT)]
    for _ in range(500):
        conc = int(rng.integers(0, 30))
        lat = int(rng.integers(100, 5000))
        code = 0 if rng.random() < 0.8 else int(jerrors.EINTERNAL)
        out = []
        for const, tmo in pairs:
            tmo.on_responded(code, lat)
            out.append((const.on_requested(conc), const.max_concurrency(),
                        tmo.on_requested(conc), tmo.max_concurrency()))
        assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(3))
def test_method_status_parity(seed):
    rng = np.random.default_rng(200 + seed)
    codes = [0, 0, 0, int(jerrors.ELIMIT), int(jerrors.ELOGOFF),
             int(jerrors.EINTERNAL)]
    statuses = [pkg.ms.MethodStatus(
        "Svc.M", limiter=pkg.lim.ConstantConcurrencyLimiter(3))
        for pkg in (JAX, PORT)]
    inflight = 0
    for _ in range(400):
        if inflight and rng.random() < 0.5:
            code = int(rng.choice(codes))
            lat = int(rng.integers(10, 1000))
            for st in statuses:
                st.on_responded(code, lat)
            inflight -= 1
        else:
            got = [st.on_requested() for st in statuses]
            assert got[0] == got[1]
            inflight += got[0]
        assert (statuses[0].concurrency, statuses[0].error_count.get_value(),
                statuses[0].shed_count.get_value()) == \
            (statuses[1].concurrency, statuses[1].error_count.get_value(),
             statuses[1].shed_count.get_value())
    d = statuses[1].describe()
    assert d["count"] == statuses[0].latency_rec.count() > 0
    assert d["errors"] > 0 and d["shed"] > 0


@pytest.mark.parametrize("seed", range(3))
def test_circuit_breaker_parity(seed):
    rng = np.random.default_rng(300 + seed)
    brs = [JAX.cb.CircuitBreaker(), PORT.cb.CircuitBreaker()]
    p_err = [0.05, 0.3, 0.7][seed]
    trips = 0
    for _ in range(600):
        code = int(jerrors.EINTERNAL) if rng.random() < p_err else 0
        got = [b.on_call_end(code) for b in brs]
        assert got[0] == got[1]
        trips += not got[1]
        assert brs[0].is_isolated() == brs[1].is_isolated()
    if seed:
        assert trips > 0
        for b in brs:
            b.mark_recovered()
        assert not brs[0].is_isolated() and not brs[1].is_isolated()
    else:
        assert trips == 0


def test_cluster_recover_policy_parity():
    for pkg in (JAX, PORT):
        pol = pkg.cb.ClusterRecoverPolicy(min_working_instances=2,
                                          hold_seconds=0.05)
        assert pol.on_cluster_size(2, 3)
        assert not pol.on_cluster_size(1, 3)      # recovery hold starts
        assert not pol.on_cluster_size(1, 3)
        time.sleep(0.06)
        assert pol.on_cluster_size(1, 3)          # hold elapsed
        assert pol.on_cluster_size(3, 3)


# ---- the JAX package's controller units, on both packages --------------

@pytest.mark.parametrize("pkg", PKGS)
class TestAdmissionQueueUnits:
    def test_strict_priority_and_drr_fairness(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0,
                             queue_capacity=64,
                             tenant_weights={"a": 3, "b": 1},
                             queueable_priority_max=1)
        order = []
        for i in range(6):
            for t in ("a", "b"):
                _submit(adm, gate, order, f"{t}{i}", 0, t, clock)
        for i in range(2):
            _submit(adm, gate, order, f"p1-{i}", 1, "a", clock)
        assert adm.queued() == 14
        gate.slots = 100
        assert adm.pump() == 14
        assert order.index("p1-0") > max(order.index(f"a{i}")
                                         for i in range(6))
        a_first4 = sum(1 for x in order[:4]
                       if isinstance(x, str) and x.startswith("a"))
        assert a_first4 == 3, order[:4]

    def test_shed_before_queue_for_sheddable_band(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0)
        order = []
        _submit(adm, gate, order, "low", 3, "t", clock)
        assert order and order[0][0] == "SHED"
        _, _, code, retry_after, _ = order[0]
        assert code == errors.ELIMIT and retry_after > 0
        assert adm.queued() == 0

    def test_fair_share_shed(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0,
                             queue_capacity=8,
                             tenant_weights={"a": 3, "b": 1})
        order = []
        _submit(adm, gate, order, "a0", 0, "a", clock)
        for i in range(3):
            _submit(adm, gate, order, f"b{i}", 0, "b", clock)
        sheds = [x for x in order if isinstance(x, tuple)]
        assert len(sheds) == 1 and sheds[0][1] == "b2"
        assert "fair share" in sheds[0][4]
        assert adm.queued() == 3

    def test_deadline_expired_shed_before_any_work(self, pkg):
        clock = [10_000_000]
        gate = _Gate(10)
        adm = _mk_controller(pkg, gate, clock)
        order = []
        adm.submit(priority=0, tenant="t", deadline_left_ms=100,
                   recv_us=clock[0] - 200_000,
                   try_enter=gate.try_enter,
                   run=lambda w: order.append("RAN"),
                   shed=lambda c, txt, ra: order.append((c, txt, ra)))
        assert order == [(errors.ERPCTIMEDOUT, pkg.adm.SHED_DEADLINE_TEXT,
                          0)]
        assert gate.slots == 10

    def test_queue_timeout_shed_with_retry_after(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=50.0,
                             max_queue_ms=30.0)
        order = []
        _submit(adm, gate, order, "q", 0, "t", clock)
        assert adm.queued() == 1
        clock[0] += 31_000
        assert adm.expire_queued() == 1
        _, _, code, ra, txt = order[0]
        assert code == errors.ELIMIT and ra > 0
        assert txt == pkg.adm.SHED_QUEUE_TIMEOUT_TEXT

    def test_retry_after_tracks_backlog_and_rate(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0,
                             queue_capacity=64)
        assert adm.retry_after_ms() == 10
        order = []
        for i in range(9):
            _submit(adm, gate, order, f"q{i}", 0, "t", clock)
        assert adm.retry_after_ms() == 100
        adm.fail_all(errors.ELOGOFF, "cleanup")

    def test_service_rate_ema_from_release_events(self, pkg):
        clock = [1_000_000]
        adm = _mk_controller(pkg, _Gate(0), clock)
        for _ in range(20):
            clock[0] += 10_000
            adm.on_release()
        assert 80.0 <= adm.service_rate() <= 120.0

    def test_fail_all_bounces_queued_and_refuses_later(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0)
        order = []
        _submit(adm, gate, order, "q0", 0, "t", clock)
        assert adm.fail_all(errors.ELOGOFF, "server stopping") == 1
        assert order[0][0] == "SHED" and order[0][2] == errors.ELOGOFF
        _submit(adm, gate, order, "q1", 0, "t", clock)
        assert order[1][0] == "SHED" and order[1][2] == errors.ELOGOFF
        adm.reset()
        gate.slots = 1
        _submit(adm, gate, order, "q2", 0, "t", clock)
        assert order[2] == "q2"

    def test_queue_bound_capped_by_residual_deadline(self, pkg):
        clock = [10_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0,
                             max_queue_ms=50.0)
        order = []
        adm.submit(priority=0, tenant="t", deadline_left_ms=50,
                   recv_us=clock[0] - 45_000,
                   try_enter=gate.try_enter,
                   run=lambda w: order.append("RAN"),
                   shed=lambda c, txt, ra: order.append((c, txt)))
        assert adm.queued() == 1
        clock[0] += 6_000
        assert adm.expire_queued() == 1
        assert order == [(errors.ELIMIT, pkg.adm.SHED_QUEUE_TIMEOUT_TEXT)]

    def test_method_gate_rollback_does_not_pump_or_poison_rate(self, pkg):
        calls = {"out": 0, "rollback": 0}

        class _SpyServer:
            def on_request_in(self):
                return True

            def on_request_out(self):
                calls["out"] += 1

            def on_request_rollback(self):
                calls["rollback"] += 1

        class _RefusingStatus:
            def on_requested(self):
                return False

        gate = pkg.adm.server_method_gate(_SpyServer(), _RefusingStatus())
        assert gate() is False
        assert calls == {"out": 0, "rollback": 1}

    def test_tenant_counter_cardinality_is_capped(self, pkg):
        clock = [1_000_000]
        gate = _Gate(1_000_000)
        adm = _mk_controller(pkg, gate, clock)
        cap = pkg.adm.AdmissionController.MAX_TRACKED_TENANTS
        for i in range(cap + 40):
            adm.submit(priority=0, tenant=f"uuid-{i}",
                       deadline_left_ms=None, recv_us=clock[0],
                       try_enter=gate.try_enter,
                       run=lambda w: None, shed=lambda c, t, r: None)
        assert len(adm._tenant_labels) == cap
        assert adm.describe()["by_tenant_band"].get(
            "admitted[~other][b0]") == 40

    def test_gate_refusal_restores_entry_at_queue_head(self, pkg):
        clock = [1_000_000]
        gate = _Gate(0)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0)
        order = []
        _submit(adm, gate, order, "first", 0, "t", clock)
        _submit(adm, gate, order, "second", 0, "t", clock)
        assert adm.pump() == 0
        assert adm.queued() == 2
        gate.slots = 2
        adm.pump()
        assert order == ["first", "second"]

    def test_mini_overload_shed_absorbs_excess(self, pkg):
        """The JAX package's deterministic mini-overload: capacity 2, a
        simulated clock, an injected 100 rps, 4 tenants offering 3:1
        low:high at 10x capacity."""
        clock = [1_000_000]
        gate = _Gate(2)
        adm = _mk_controller(pkg, gate, clock, service_rate_override=100.0,
                             queue_capacity=16, max_queue_ms=20.0)
        tenants = [f"t{i}" for i in range(4)]
        out = {"hi_ok": {t: 0 for t in tenants}, "lo_ok": 0, "shed": 0,
               "hints": []}
        inflight = []

        def submit(pri, tenant):
            def shed(code, txt, ra):
                out["shed"] += 1
                if code == errors.ELIMIT:
                    out["hints"].append(ra)
                assert code in (errors.ELIMIT, errors.ERPCTIMEDOUT)
            adm.submit(priority=pri, tenant=tenant, deadline_left_ms=500,
                       recv_us=clock[0], try_enter=gate.try_enter,
                       run=(lambda w, p=pri, t=tenant:
                            inflight.append((p, t))),
                       shed=shed)

        def complete_one():
            if inflight:
                pri, t = inflight.pop(0)
                if pri == 0:
                    out["hi_ok"][t] += 1
                else:
                    out["lo_ok"] += 1
                gate.release()
                adm.on_release()

        for tick in range(40):
            clock[0] += 10_000
            for ti, t in enumerate(tenants):
                submit(0 if (tick + ti) % 4 == 0 else 3, t)
            complete_one()
            adm.expire_queued()
        for _ in range(30):
            clock[0] += 10_000
            complete_one()
            adm.expire_queued()
        assert adm.queued() == 0
        assert out["shed"] > 80
        assert out["hints"] and all(h > 0 for h in out["hints"])
        assert all(n > 0 for n in out["hi_ok"].values()), out["hi_ok"]
        assert sum(out["hi_ok"].values()) > out["lo_ok"]


class _SpyLimiter:
    def __init__(self):
        self.samples = []

    def on_requested(self, conc):
        return True

    def on_responded(self, code, latency_us):
        self.samples.append((code, latency_us))

    def max_concurrency(self):
        return 1 << 30


@pytest.mark.parametrize("pkg", PKGS)
def test_shed_codes_skip_limiter_and_error_count(pkg):
    lim = _SpyLimiter()
    ms = pkg.ms.MethodStatus("Svc.M", limiter=lim)
    assert ms.on_requested()
    ms.on_responded(errors.ELIMIT, 5000)
    assert ms.on_requested()
    ms.on_responded(errors.ELOGOFF, 5000)
    assert lim.samples == []
    assert ms.error_count.get_value() == 0
    assert ms.shed_count.get_value() == 2
    assert ms.on_requested()
    ms.on_responded(0, 1000)
    assert ms.on_requested()
    ms.on_responded(errors.EINTERNAL, 1000)
    assert lim.samples == [(0, 1000), (errors.EINTERNAL, 1000)]
    assert ms.error_count.get_value() == 1
    assert ms.concurrency == 0


# ---------------------------------------------------------------------
# the port's server: mem:// and ici:// (CPU mesh, plane engaged)
# ---------------------------------------------------------------------

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")


@pytest.fixture(params=["mem", "ici"])
def plane(request):
    """The call plane: ``mem://`` or ``ici://`` on a CPU mesh whose
    attachments at or above 1 KiB ride the device plane (the plain
    p2p_copy).  Yields a function naming a fresh endpoint."""
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    counter = iter(range(64))
    if request.param == "ici":
        IciMesh.set_default(IciMesh(ranks=8, device="cpu"))
        tflags.set_flag("ici_device_plane", True)
        tflags.set_flag("ici_device_plane_host_mesh", True)
        tflags.set_flag("ici_device_plane_threshold", 1024)

        def name(tag):
            return f"ici://{2 + next(counter) % 6}"
    else:
        def name(tag):
            return f"mem://adm-{tag}-{next(counter)}"
    yield types.SimpleNamespace(kind=request.param, name=name)
    for n, v in saved.items():
        tflags.set_flag(n, v)
    if request.param == "ici":
        IciMesh.set_default(None)


def _attach(cntl, kind, nbytes=4096, fill=7):
    """A DEVICE attachment owned by rank 1 on the ici plane (it rides the
    plane to the server), a host one on mem://."""
    if kind == "ici":
        mesh = IciMesh.default()
        cntl.request_attachment.append_device_array(
            mesh.own(torch.full((nbytes,), fill, dtype=torch.uint8), 1))
    else:
        cntl.request_attachment.append(bytes([fill]) * nbytes)


def _overloadable_server(addr, *, rate=50.0, queue_ms=2000.0):
    gate = threading.Event()
    entered = []

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            if request.message == "block":
                entered.append(1)
                gate.wait(10)
            response.message = f"{cntl.priority}/{cntl.tenant}"
            done()

    server = rpc.Server(rpc.ServerOptions(
        max_concurrency=2,
        admission=rpc.AdmissionOptions(max_queue_ms=queue_ms,
                                       service_rate_override=rate)))
    server.add_service(Echo())
    assert server.start(addr) == 0
    return server, gate, entered


def _saturate(ch, entered, n=2):
    threads = []
    for _ in range(n):
        def blocker():
            c = rpc.Controller()
            c.priority = 0
            ch.call_method("Echo.Echo", c, EchoRequest(message="block"),
                           EchoResponse)
        t = threading.Thread(target=blocker)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + 5
    while len(entered) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(entered) == n, "server slots did not fill"
    return threads


def _channel(target, timeout_ms=4000, max_retry=0):
    ch = rpc.Channel()
    ch.init(target, options=rpc.ChannelOptions(timeout_ms=timeout_ms,
                                       max_retry=max_retry))
    return ch


def test_plane_shed_semantics(plane):
    """A sheddable-band request sheds at once with retryable ELIMIT and a
    hint, its attachment having crossed the plane; a high-priority
    request queues and completes when a slot frees; priority and tenant
    reach the handler."""
    addr = plane.name("shed")
    server, gate, entered = _overloadable_server(addr)
    ch = _channel(addr)
    threads = []
    try:
        threads = _saturate(ch, entered)
        c = rpc.Controller()
        c.priority = 3
        c.tenant = "bulk"
        _attach(c, plane.kind, 8192)
        r = ch.call_method("Echo.Echo", c, EchoRequest(message="x"),
                           EchoResponse)
        assert r is None and c.error_code_ == errors.ELIMIT
        assert c.retry_after_ms > 0 and "shed" in c.error_text_
        res = {}

        def hp():
            c2 = rpc.Controller()
            c2.priority = 0
            c2.tenant = "svc"
            r2 = ch.call_method("Echo.Echo", c2, EchoRequest(message="hi"),
                                EchoResponse)
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
        server.stop()


def test_draining_bounces_queued_entries_with_elogoff(plane):
    addr = plane.name("drainq")
    server, gate, entered = _overloadable_server(addr)
    ch = _channel(addr)
    threads = []
    try:
        threads = _saturate(ch, entered)
        res = {}

        def hp():
            c2 = rpc.Controller()
            c2.priority = 0
            ch.call_method("Echo.Echo", c2, EchoRequest(message="hi"),
                           EchoResponse)
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
        assert res["code"] == errors.ELOGOFF
        gate.set()
        stopper.join(10)
        assert not server.is_running() and server.inflight_requests() == 0
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()


def test_stale_request_shed_before_parse():
    """A request whose deadline budget was spent before it reached the
    gate (a stale cut stamp) is shed before any work, with the distinct
    deadline-shed text."""
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.policy import tpu_std
    from brpc_tpu_torch.proto import rpc_meta_pb2 as meta_pb
    ran = []

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            ran.append(1)
            done()

    server = rpc.Server(rpc.ServerOptions(admission=True))
    server.add_service(Echo())
    assert server.start("mem://adm-deadline") == 0
    try:
        meta = meta_pb.RpcMeta()
        meta.correlation_id = 7
        meta.request.service_name = "Echo"
        meta.request.method_name = "Echo"
        meta.request.deadline_left_ms = 50
        body = IOBuf()
        body.append(EchoRequest(message="x").SerializeToString())
        msg = tpu_std.StdMessage(meta, body)
        msg.recv_ns = time.monotonic_ns() - 200_000_000
        writes = []

        class _Sock:
            remote_side = None

            def write(self, frame, notify_cid=None):
                writes.append(frame.to_bytes())
                return 0

        tpu_std.process_request(msg, _Sock(), server)
        assert writes and not ran
        raw = writes[0]
        meta_size = int.from_bytes(raw[4:8], "big")
        rmeta = meta_pb.RpcMeta()
        rmeta.ParseFromString(raw[12:12 + meta_size])
        assert rmeta.response.error_code == errors.ERPCTIMEDOUT
        assert rmeta.response.error_text == tadm.SHED_DEADLINE_TEXT
    finally:
        server.stop()


def test_wire_gate_reject_does_not_skew_method_status(plane):
    gate = threading.Event()
    entered = threading.Event()

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            entered.set()
            gate.wait(5)
            response.message = "ok"
            done()

    addr = plane.name("gate")
    server = rpc.Server(rpc.ServerOptions(max_concurrency=1))
    server.add_service(Echo())
    assert server.start(addr) == 0
    status = server.method_status("Echo.Echo")
    spy = _SpyLimiter()
    status.limiter = spy
    ch = _channel(addr, timeout_ms=3000)
    try:
        t = threading.Thread(target=lambda: ch.call_method(
            "Echo.Echo", rpc.Controller(), EchoRequest(message="b"),
            EchoResponse))
        t.start()
        assert entered.wait(3)
        cntl = rpc.Controller()
        _attach(cntl, plane.kind)
        ch.call_method("Echo.Echo", cntl, EchoRequest(message="x"),
                       EchoResponse)
        assert cntl.error_code_ == errors.ELIMIT
        gate.set()
        t.join(5)
        deadline = time.monotonic() + 3
        while status.concurrency != 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert status.concurrency == 0
        assert status.error_count.get_value() == 0
        assert all(code == 0 for code, _ in spy.samples), spy.samples
        assert server.inflight_requests() == 0
    finally:
        gate.set()
        ch.close()
        server.stop()


def test_method_limited_server_release_does_not_recurse(plane):
    gate_evt = threading.Event()
    entered = []

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            if request.message == "block":
                entered.append(1)
                gate_evt.wait(10)
            response.message = "ok"
            done()

    addr = plane.name("mlimit")
    server = rpc.Server(rpc.ServerOptions(
        method_max_concurrency={"Echo.Echo": 1},
        admission=rpc.AdmissionOptions(max_queue_ms=3000.0,
                                       service_rate_override=50.0)))
    server.add_service(Echo())
    assert server.start(addr) == 0
    ch = _channel(addr)
    threads = []
    try:
        threads = _saturate(ch, entered, n=1)
        results = []
        lock = threading.Lock()

        def hp(i):
            c = rpc.Controller()
            c.priority = 0
            ch.call_method("Echo.Echo", c, EchoRequest(message=f"q{i}"),
                           EchoResponse)
            with lock:
                results.append(c.error_code_)
        qthreads = [threading.Thread(target=hp, args=(i,))
                    for i in range(8)]
        for t in qthreads:
            t.start()
        deadline = time.monotonic() + 3
        while server.admission.queued() < 8 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.admission.queued() == 8
        gate_evt.set()
        for t in qthreads:
            t.join(10)
        assert results == [0] * 8, results
        assert server.admission.service_rate() == 50.0
    finally:
        gate_evt.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()


def test_client_retry_waits_for_hint_then_succeeds(plane):
    # service_rate_override=10 -> retry_after = 1000 * (0 + 1) / 10 ms.
    # The mem leg rides the socket plane: the loopback plane completes a
    # shed in place, with no retry, as the JAX package's does
    saved = tflags.get_flag("mem_loopback_fast")
    tflags.set_flag("mem_loopback_fast", False)
    try:
        _client_retry_waits_for_hint(plane)
    finally:
        tflags.set_flag("mem_loopback_fast", saved)


def _client_retry_waits_for_hint(plane):
    addr = plane.name("retry")
    server, gate, entered = _overloadable_server(addr, rate=10.0)
    ch = _channel(addr, max_retry=3)
    threads = []
    try:
        warm = rpc.Controller()
        ch.call_method("Echo.Echo", warm, EchoRequest(message="w"),
                       EchoResponse)
        assert not warm.failed(), warm.error_text
        threads = _saturate(ch, entered)
        t_free = threading.Timer(0.05, gate.set)
        t_free.start()
        c = rpc.Controller()
        c.priority = 3
        t0 = time.monotonic()
        r = ch.call_method("Echo.Echo", c, EchoRequest(message="x"),
                           EchoResponse)
        dt = time.monotonic() - t0
        assert c.error_code_ == 0 and r is not None
        assert c.retried_count >= 1
        assert dt >= 0.1, dt
        t_free.cancel()
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()


def test_sheds_do_not_trip_the_client_circuit_breaker(plane):
    addr = plane.name("breaker")
    server, gate, entered = _overloadable_server(addr)
    ch = _channel(addr, timeout_ms=2000)
    threads = []
    try:
        threads = _saturate(ch, entered)
        for _ in range(60):
            c = rpc.Controller()
            c.priority = 3
            ch.call_method("Echo.Echo", c, EchoRequest(message="x"),
                           EchoResponse)
            assert c.error_code_ == errors.ELIMIT
        assert not tcb.BreakerRegistry.instance().breaker(
            ch._endpoint).is_isolated()
        gate.set()
        for t in threads:
            t.join(5)
        threads = []
        c = rpc.Controller()
        c.priority = 0
        r = ch.call_method("Echo.Echo", c, EchoRequest(message="after"),
                           EchoResponse)
        assert c.error_code_ == 0 and r is not None
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()


def test_isolated_endpoint_fails_fast_until_revived():
    """The Channel's breaker gate: while the endpoint's breaker isolates
    it a call fails without reaching the server; the health checker's
    probe (run here directly) revives it."""
    from brpc_tpu_torch.rpc import health_check

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = "ok"
            done()

    server = rpc.Server()
    server.add_service(Echo())
    assert server.start("mem://adm-isolated") == 0
    ch = _channel("mem://adm-isolated")
    breaker = tcb.BreakerRegistry.instance().breaker(ch._endpoint)
    try:
        for _ in range(40):           # trip: the short EMA passes 0.5
            if not breaker.on_call_end(errors.EINTERNAL):
                break
        assert breaker.is_isolated()
        c = rpc.Controller()
        ch.call_method("Echo.Echo", c, EchoRequest(message="x"),
                       EchoResponse)
        assert c.error_code_ == errors.EFAILEDSOCKET
        assert server.method_status("Echo.Echo").latency_rec.count() == 0
        task = health_check.start_health_check(ch._endpoint)
        assert task.probe_now()
        assert not breaker.is_isolated()
        c = rpc.Controller()
        r = ch.call_method("Echo.Echo", c, EchoRequest(message="y"),
                           EchoResponse)
        assert not c.failed() and r.message == "ok"
    finally:
        breaker.mark_recovered()
        ch.close()
        server.stop()


def test_a_shed_request_lets_go_of_both_attachments(monkeypatch):
    """Under overload a shed request has already crossed the plane: once
    the shed is answered and the caller drops its Controller, neither the
    caller's source tensor nor the server's received copy may stay alive
    (not in a cancelled deadline timer, not in an idle worker's last
    tasklet), or overload holds device memory per shed request."""
    import gc
    import weakref
    from brpc_tpu_torch.ici import device_plane as dp
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 1024)
    received = []
    real_run = dp.DevicePlane._run

    def run(self, t):
        out, ev = real_run(self, t)
        received.append(weakref.ref(out))
        return out, ev
    monkeypatch.setattr(dp.DevicePlane, "_run", run)
    server, gate, entered = _overloadable_server("ici://6")
    ch = _channel("ici://6", timeout_ms=30000)
    threads = []
    try:
        threads = _saturate(ch, entered)
        sent = []
        for i in range(4):
            c = rpc.Controller()
            c.priority = 3
            src = mesh.own(torch.full((65536,), i, dtype=torch.uint8), 1)
            sent.append(weakref.ref(src))
            c.request_attachment.append_device_array(src)
            del src
            ch.call_method("Echo.Echo", c, EchoRequest(message="x"),
                           EchoResponse)
            assert c.error_code_ == errors.ELIMIT and c.retry_after_ms > 0
            del c
        assert len(received) == 4
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline:
            gc.collect()
            alive = [r for r in sent + received if r() is not None]
            if not alive:
                break
            time.sleep(0.01)
        assert not alive, f"{len(alive)} shed attachments still alive"
    finally:
        gate.set()
        for t in threads:
            t.join(5)
        ch.close()
        server.stop()
        for n, v in saved.items():
            tflags.set_flag(n, v)
        IciMesh.set_default(None)


# ---- the JAX package's TestLimiters and TestCircuitBreaker, on both ------

def _drive_limiter(lim, windows, concurrency_fn, base_us=10_000, knee=20,
                   now_us=1_000_000):
    """A simulated server with a knee: latency flat at base_us up to
    ``knee`` concurrent requests, then growing linearly.  Returns the
    advanced clock."""
    for _ in range(windows):
        c = max(1, min(concurrency_fn(lim.max_concurrency()), 200))
        lat = base_us if c <= knee else int(base_us * c / knee)
        qps = c / (lat / 1e6)
        span_us = 200_000
        n = max(int(qps * span_us / 1e6), 1)
        step = span_us // n
        for _ in range(n):
            now_us += step
            lim.add_sample(0, lat, now_us)
    return now_us


@pytest.mark.parametrize("pkg", PKGS)
class TestLimiters:
    def test_constant(self, pkg):
        lim = pkg.lim.ConstantConcurrencyLimiter(2)
        assert lim.on_requested(0) and lim.on_requested(1)
        assert not lim.on_requested(2)

    def test_auto_gradient_converges_near_the_knee(self, pkg):
        lim = pkg.lim.AutoConcurrencyLimiter(initial=40)
        _drive_limiter(lim, 300, lambda m: min(m, 150))
        assert 14 <= lim.max_concurrency() <= 45, lim.max_concurrency()
        assert lim.remeasure_count >= 1

    def test_auto_gradient_tracks_a_capacity_collapse(self, pkg):
        lim = pkg.lim.AutoConcurrencyLimiter(
            initial=40, remeasure_interval_us=60_000_000)
        now = _drive_limiter(lim, 150, lambda m: min(m, 150))
        assert lim.max_concurrency() >= 14
        _drive_limiter(lim, 300, lambda m: min(m, 150), knee=3, now_us=now)
        assert lim.max_concurrency() <= 10, lim.max_concurrency()

    def test_auto_gradient_failures_punish_the_window(self, pkg):
        healthy = pkg.lim.AutoConcurrencyLimiter(
            initial=40, remeasure_interval_us=60_000_000)
        degraded = pkg.lim.AutoConcurrencyLimiter(
            initial=40, remeasure_interval_us=60_000_000)
        now_h = _drive_limiter(healthy, 30, lambda m: min(m, 10))
        now_d = _drive_limiter(degraded, 30, lambda m: min(m, 10))
        for _ in range(200):
            now_h += 5_000
            now_d += 5_000
            healthy.add_sample(0, 10_000, now_h)
            degraded.add_sample(0, 10_000, now_d)
            degraded.add_sample(1, 80_000, now_d)
        assert degraded.max_concurrency() < healthy.max_concurrency()

    def test_timeout_limiter(self, pkg):
        lim = pkg.lim.TimeoutConcurrencyLimiter(timeout_ms=10)
        for _ in range(20):
            lim.on_responded(0, 5000)
        assert lim.on_requested(1)
        assert not lim.on_requested(50)


@pytest.mark.parametrize("pkg", PKGS)
class TestCircuitBreaker:
    def test_trips_on_errors_and_recovers(self, pkg):
        cb = pkg.cb.CircuitBreaker()
        assert any(not cb.on_call_end(1009) for _ in range(30))
        assert cb.is_isolated()
        cb.mark_recovered()
        assert not cb.is_isolated()

    def test_healthy_traffic_never_trips(self, pkg):
        cb = pkg.cb.CircuitBreaker()
        assert all(cb.on_call_end(0) for _ in range(1000))

    def test_isolation_duration_doubles(self, pkg):
        cb = pkg.cb.CircuitBreaker()
        for _ in range(50):
            cb.on_call_end(1009)
        first = cb._isolation_ms
        cb._isolated_until = 0
        for _ in range(50):
            cb.on_call_end(1009)
        assert cb._isolation_ms >= first


def test_an_in_place_writer_is_not_held_by_later_writers():
    """Under overload every caller writes to the one shared connection.
    The caller that finds the socket idle writes its own request in
    place and returns; later writers' requests go to KeepWrite.  (A
    writer that drained everyone's requests stalled its own call until
    the load stopped: seconds, and a starved tenant, at 10x overload.)
    Six callers each keep one write outstanding, as RPC callers do."""
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.rpc.socket import Socket

    written = []

    class SlowSocket(Socket):
        def _do_write(self, data):
            time.sleep(0.002)
            n = len(data)
            written.append(data.cut(n).to_bytes())
            return n

        def _transport_close(self):
            pass

    sock = SlowSocket()
    stop = time.monotonic() + 1.0
    sent = [0]
    waits = []
    lock = threading.Lock()

    def caller(tag):
        while time.monotonic() < stop:
            buf = IOBuf()
            buf.append(tag)
            done = threading.Event()
            t0 = time.monotonic()
            assert sock.write(buf, on_done=lambda code: done.set()) == 0
            returned = time.monotonic() - t0
            assert done.wait(5)
            with lock:
                sent[0] += 1
                waits.append(returned)

    threads = [threading.Thread(target=caller, args=(bytes([65 + i]),))
               for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        # an in-place write is one 2 ms write, not the others' backlog
        assert max(waits) < 0.1, max(waits)
        assert len(written) == sent[0] > 100
        assert {w for w in written} == {bytes([65 + i]) for i in range(6)}
    finally:
        sock.set_failed(errors.ECLOSE, "test done")
