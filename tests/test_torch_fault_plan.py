"""The fabric fault plan (``rpc/fault_injection.py``) held against the JAX
package's, for the knobs of the planes the port has: the control channel,
the handshake, the device plane's posts and the collective fan-out.

Mirrors ``tests/test_chaos_fabric.py``:

  * units, each on both packages with the same seeds and calls: seeded
    plans reproduce identical decisions, the same as the JAX plan's
    (``:244``); ``inject_fabric`` scopes and restores (``:253``); ``match``
    scopes a plan to sockets (``:264``); refusal budgets are exact
    (``:273``, ``:281``); a slow plane never degrades (``:590``).  The
    port refuses the bulk, shm and transfer-server knobs, naming the tier
    they wait for;
  * two processes (fresh interpreters, no JAX): the control channel
    severed mid-call, then revival during the outage under a new socket
    id (``:1113``); a peer killed by ``die_after_control_frames`` failing
    the in-flight call promptly with a retryable code (``:1174``);
  * a refused device post.  The JAX package sends the payload on its bulk
    plane (or inline) in the same frame and the call succeeds
    (``:1186-1268``); the port has no such tier, so the call fails with
    EINTERNAL and the reason, nothing crosses as kind 4, and the device
    plane to that peer stays latched down for the next call.
"""
from __future__ import annotations

import threading
import time
import types

import pytest

from brpc_tpu.ici import plane_health as jph
from brpc_tpu.rpc import fault_injection as jfi
from brpc_tpu_torch.ici import plane_health as tph
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import fault_injection as tfi

from tests.torch_procs import ok, run_procs

JAX = types.SimpleNamespace(fi=jfi, ph=jph, name="jax")
PORT = types.SimpleNamespace(fi=tfi, ph=tph, name="port")
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


class _FakeSock:
    is_server_side = False
    remote_side = None


def _decisions(fi, seed):
    plan = fi.FabricFaultPlan(seed=seed, control_drop_ratio=0.3)
    s = _FakeSock()
    return [plan.on_control_send(s) for _ in range(200)], plan.injected


def test_seeded_plans_reproduce_the_jax_decisions():
    for seed in (7, 8):
        (jd, jinj), (td, tinj) = _decisions(jfi, seed), _decisions(tfi, seed)
        assert td == jd
        assert tinj["control_drop"] == jinj["control_drop"] > 0
    assert _decisions(tfi, 7)[0] == _decisions(tfi, 7)[0]
    assert _decisions(tfi, 7)[0] != _decisions(tfi, 8)[0]


@BOTH
def test_inject_fabric_scopes_and_restores(pkg):
    fi = pkg.fi
    outer = fi.FabricFaultPlan(seed=1)
    inner = fi.FabricFaultPlan(seed=2)
    assert fi.fabric_active() is None
    with fi.inject_fabric(outer):
        assert fi.fabric_active() is outer
        with fi.inject_fabric(inner):
            assert fi.fabric_active() is inner
        assert fi.fabric_active() is outer
    assert fi.fabric_active() is None


@BOTH
def test_match_scopes_plan_to_sockets(pkg):
    fi = pkg.fi
    hit, miss = _FakeSock(), _FakeSock()
    plan = fi.FabricFaultPlan(control_sever_after_frames=1,
                              match=lambda s: s is hit)
    assert plan.on_control_send(miss) == fi.PASS
    assert plan.on_control_send(hit) == fi.ERROR
    assert plan.on_control_send(hit) == fi.PASS      # fires once
    assert plan.injected["control_sever"] == 1
    posts = fi.FabricFaultPlan(device_plane_fail_posts=5,
                               match=lambda s: s is hit)
    assert not posts.on_device_post(miss)
    assert posts.on_device_post(hit)
    assert posts.injected["device_plane"] == 1


def _budgets(fi):
    plan = fi.FabricFaultPlan(refuse_hellos=1, device_plane_fail_posts=2,
                              collective_drop_announces=2,
                              collective_fail_execs=1,
                              collective_kill_device=3)
    seq = [plan.on_hello(), plan.on_hello(),
           plan.on_device_post(), plan.on_device_post(),
           plan.on_device_post(),
           plan.on_collective_announce(), plan.on_collective_announce(),
           plan.on_collective_announce(),
           plan.on_collective_execute((0, 1)),
           plan.on_collective_execute((0, 1)),
           plan.on_collective_execute((2, 3)),
           plan.on_collective_execute((2, 3))]
    return seq, plan.injected


def test_refusal_budgets_are_exact_and_equal_jax():
    (jseq, jinj), (tseq, tinj) = _budgets(jfi), _budgets(tfi)
    assert tseq == jseq
    assert tseq[:8] == [True, False, True, True, False, True, True, False]
    assert tseq[8] == "injected collective execution failure"
    assert tseq[9] is None
    assert tseq[10] == tseq[11] == "member ici://3 killed mid-fan-out"
    assert tinj == {k: jinj[k] for k in tinj}
    assert tinj["refuse_hello"] == 1 and tinj["device_plane"] == 2
    assert tinj["coll_announce_drop"] == 2 and tinj["collective"] == 3


@BOTH
def test_slow_delays_only_the_planes_it_names(pkg):
    plan = pkg.fi.FabricFaultPlan(plane_slow_ms={"device": 20})
    t0 = time.monotonic()
    plan.on_plane_op(None, "device")
    assert time.monotonic() - t0 >= 0.02
    t0 = time.monotonic()
    plan.on_plane_op(None, "collective")
    assert time.monotonic() - t0 < 0.02
    assert plan.injected["plane_slow"] == 1


def test_slow_never_degrades_the_ports_planes():
    """SLOW on the device plane (the fabric's timer latch) and the
    collective plane (the epoch policy): latency is not death."""
    specs = {"device": dict(retry_s=lambda: 0.1),
             "collective": dict(epoch_fn=lambda: 1)}
    plan = tfi.FabricFaultPlan(plane_slow_ms={p: 10 for p in specs})
    before = troute.plane_stats()
    with tfi.inject_fabric(plan):
        for plane, policy in specs.items():
            rec = tph.register_plane(f"tfp_slow_{plane}", threading.Lock(),
                                     **policy)
            for _ in range(3):
                plan.on_plane_op(None, plane)
                assert rec.usable() is True
            snap = rec.snapshot()
            assert snap["state"] == tph.UP and snap["downs"] == 0
    after = troute.plane_stats()
    assert {k: v for k, v in after.items() if k.startswith("tfp_slow")
            and v != before.get(k, 0)} == {}
    assert plan.injected["plane_slow"] == 6


@pytest.mark.parametrize("knob,value,tier", [
    ("bulk_sever_now", True, "bulk plane"),
    ("bulk_drop_frames", 1, "bulk plane"),
    ("refuse_bulk_handshakes", 1, "bulk plane"),
    ("shm_kill_now", True, "shm ring"),
    ("refuse_shm_handshakes", 1, "shm ring"),
    ("xfer_refuse_stages", 1, "transfer server"),
])
def test_knobs_of_missing_tiers_are_refused(knob, value, tier):
    """Only the transfer server's knob is still refused; the bulk plane's
    and the shm ring's are ported and decide as the JAX plan does (the
    native mode armed on an attach, the handshake refusals counted)."""
    jplan = jfi.FabricFaultPlan(**{knob: value})  # the JAX plan has it
    if tier == "transfer server":
        with pytest.raises(ValueError, match=tier):
            tfi.FabricFaultPlan(**{knob: value})
        return
    tplan = tfi.FabricFaultPlan(**{knob: value})
    calls = {}
    for pkg, plan in (("jax", jplan), ("port", tplan)):
        seen = []

        class Lib:
            def __getattr__(self, name, seen=seen):
                return lambda h, mode, arg: seen.append(
                    (name.rsplit("_", 2)[-2], h, mode, arg))

        plan.on_bulk_attach(None, Lib(), 7)
        plan.on_shm_attach(None, Lib(), 9)
        refusals = (plan.on_bulk_handshake(), plan.on_bulk_handshake(),
                    plan.on_shm_handshake(), plan.on_shm_handshake())
        calls[pkg] = (seen, refusals, plan.injected)
    assert calls["port"] == calls["jax"]


def test_slow_planes_and_unknown_knobs_are_refused():
    with pytest.raises(ValueError, match="xfer"):
        tfi.FabricFaultPlan(plane_slow_ms={"xfer": 5})
    for plane in ("shm", "bulk", "device", "collective"):
        tfi.FabricFaultPlan(plane_slow_ms={plane: 5})
    with pytest.raises(TypeError):
        tfi.FabricFaultPlan(no_such_knob=1)
    assert set(tfi.FabricFaultPlan().injected) \
        == set(jfi.FabricFaultPlan().injected)


# ---------------------------------------------------------------------------
# Two processes.
# ---------------------------------------------------------------------------

_ECHO = r"""
from brpc_tpu_torch.rpc import fault_injection as fi
from brpc_tpu_torch.rpc import health_check
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.socket import Socket

class EchoSvc(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "srv:" + request.message
        done()

def serve(rank):
    s = rpc.Server(rpc.ServerOptions(native_ici=False))
    s.add_service(EchoSvc())
    assert s.start("ici://%d" % rank) == 0
    return s

def echo(ch, text, **kw):
    cntl = rpc.Controller()
    for k, v in kw.items():
        setattr(cntl, k, v)
    t0 = time.monotonic()
    resp = ch.call_method("EchoSvc.Echo", cntl, EchoRequest(message=text),
                          EchoResponse)
    return cntl, resp, time.monotonic() - t0
"""

_CONTROL_SEVER = _ECHO + r"""
out = {}
if pid == 0:
    server = serve(0)
    put("up", 1)
    get("rpc1_done")
    # the NEXT control frame this server writes (RPC 2's response) severs
    # the control connection instead: the client sees a reset mid-call
    plan = fi.FabricFaultPlan(seed=5, control_sever_after_frames=1,
                              match=lambda s: s.is_server_side)
    fi.install_fabric(plan)
    put("armed", 1)
    get("rpc2_failed")
    fi.install_fabric(None)
    out["injected"] = plan.injected["control_sever"]
    server.stop()                        # the outage
    put("srv_down", 1)
    time.sleep(2.0)
    server = serve(0)                    # the peer returns
    get("client_done", 120)
    server.stop()
else:
    get("up")
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=20000,
                                                  max_retry=0))
    cntl, resp, _ = echo(ch, "one")
    assert not cntl.failed(), cntl.error_text
    old = [s for s in fabric_socks() if not s.failed]
    old_sid, ep = old[0].id, old[0].remote_side
    put("rpc1_done", 1)
    get("armed")
    cntl, _, dt = echo(ch, "two")
    out["rpc2"] = [cntl.failed(), cntl.error_code_, dt,
                   Controller._retryable(cntl.error_code_)]
    put("rpc2_failed", 1)
    get("srv_down")
    out["ping_down"] = node.ping(0)
    end = time.time() + 5
    while not health_check.checking(ep) and time.time() < end:
        time.sleep(0.02)
    out["checking"] = health_check.checking(ep)
    # issued DURING the outage, with spaced retries: succeeds on return
    cntl, resp, _ = echo(ch, "during", timeout_ms=15000, max_retry=40,
                         retry_backoff_ms=50)
    out["during"] = [cntl.failed(), resp.message, cntl.retried_count]
    new = [s for s in fabric_socks() if not s.failed]
    out["new_sid"] = bool(new) and all(s.id != old_sid for s in new)
    out["old_revoked"] = Socket.address(old_sid) is None
    out["ping_up"] = node.ping(0)
    end = time.time() + 10
    while health_check.checking(ep) and time.time() < end:
        time.sleep(0.05)
    out["check_retired"] = not health_check.checking(ep)
    ch.close()
    put("client_done", 1)
out["foreign"] = foreign()
result(out)
finish()
"""

_PEER_KILL = _ECHO + r"""
out = {}
if pid == 1:
    # control frame 1 = RPC 1's request (served); frame 2 = RPC 2's
    # request: the process dies before answering
    fi.install_fabric(fi.FabricFaultPlan(seed=9,
                                         die_after_control_frames=2))
    server = serve(2)
    put("up", 1)
    time.sleep(300)                      # killed long before this returns
    print("UNREACHABLE", flush=True)
else:
    get("up")
    ch = rpc.Channel()
    ch.init("ici://2", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    cntl, resp, _ = echo(ch, "one")
    out["rpc1"] = [cntl.failed(), resp.message]
    cntl, _, dt = echo(ch, "two")
    out["rpc2"] = [cntl.failed(), cntl.error_code_, dt,
                   Controller._retryable(cntl.error_code_)]
    ch.close()
    out["foreign"] = foreign()
    result(out)
"""

_DEVICE_POST = r"""
from brpc_tpu_torch.rpc import fault_injection as fi
from brpc_tpu_torch.butil.iobuf import IOBuf
N = 128 * 1024
flags.set_flag("ici_device_plane_threshold", 4096)
out = {}
if pid == 0:
    got = []

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            got.append(len(cntl.request_attachment))
            done()

    server = rpc.Server(rpc.ServerOptions(native_ici=False))
    server.add_service(Sink())
    assert server.start("ici://0") == 0
    put("up", 1)
    get("client_done", 120)
    out["received"] = got
    server.stop()
else:
    plan = fi.FabricFaultPlan(device_plane_fail_posts=999)
    fi.install_fabric(plan)
    get("up")
    payload = mesh.own(torch.arange(N, dtype=torch.int64).remainder(249)
                       .to(torch.uint8), 2)
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=10000,
                                                  max_retry=0))
    calls = []
    for text in ("a", "b"):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        ch.call_method("Sink.Push", cntl, EchoRequest(message=text),
                       EchoResponse)
        calls.append([cntl.failed(), cntl.error_code_, cntl.error_text])
    out["calls"] = calls
    out["injected"] = plan.injected["device_plane"]
    out["kind4_sent"] = sum(s.dplane_bytes_sent for s in fabric_socks())
    out["route"] = route.route_stats()
    fi.install_fabric(None)
    ch.close()
    put("client_done", 1)
out["foreign"] = foreign()
result(out)
finish()
"""


@pytest.fixture(scope="module")
def legs():
    """The three two-process scenarios, run at once."""
    out = {}

    def run(name, body, timeout=120):
        out[name] = run_procs(body, 2, timeout=timeout)

    ts = [threading.Thread(target=run, args=a) for a in (
        ("sever", _CONTROL_SEVER), ("kill", _PEER_KILL),
        ("post", _DEVICE_POST))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    return out


def test_control_sever_fails_fast_then_revival_during_outage(legs):
    srv, cli = ok(legs["sever"])
    assert srv["injected"] == 1
    failed, code, dt, retryable = cli["rpc2"]
    assert failed and retryable, code
    assert dt < 8, f"burned the deadline instead of failing fast: {dt}"
    assert cli["ping_down"] is False and cli["checking"] is True
    failed, message, retried = cli["during"]
    assert not failed and message == "srv:during" and retried > 0
    assert cli["new_sid"] and cli["old_revoked"]
    assert cli["ping_up"] is True and cli["check_retired"]
    assert srv["foreign"] == cli["foreign"] == []


def test_peer_killed_by_die_after_frames_fails_inflight_promptly(legs):
    res = legs["kill"]
    (rc0, cli, text0), (rc1, victim, text1) = res
    assert rc0 == 0 and cli is not None, text0[-3000:]
    assert rc1 == 137 and victim is None, text1[-3000:]
    assert "UNREACHABLE" not in text1
    assert cli["rpc1"] == [False, "srv:one"]
    failed, code, dt, retryable = cli["rpc2"]
    assert failed and retryable, code
    assert dt < 10, f"burned the 30 s deadline: {dt}"


def test_refused_device_post_fails_einternal_no_host_route(legs):
    """The port's outcome beside the JAX package's: the JAX call succeeds
    on the bulk plane or inline; the port's fails with EINTERNAL and the
    refusal's reason, the first consulting the plan and the second
    refused by the down latch without it."""
    srv, cli = ok(legs["post"])
    (f1, c1, t1), (f2, c2, t2) = cli["calls"]
    assert f1 and c1 == errors.EINTERNAL, (c1, t1)
    assert "injected device-plane post refusal" in t1
    assert f2 and c2 == errors.EINTERNAL, (c2, t2)
    assert "down" in t2
    assert cli["injected"] == 1
    assert cli["kind4_sent"] == 0
    assert cli["route"].get("device_frames", 0) == 0
    assert srv["received"] == []
    assert srv["foreign"] == cli["foreign"] == []
