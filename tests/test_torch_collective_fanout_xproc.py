"""The compiled fan-out's cross-process leg (channels/collective_fanout.py)
held against the JAX package on the CPU.

  * In one process, on the same seeded numpy operand: the port's
    cross-process execution — the client's export of the operand, three
    "member processes" each pulling its rows from it through the
    shared-memory carrier and exporting its results, the client's pulls
    and merge — equals the port's local leg, which equals the JAX
    package's ``_prepare_xproc`` program run as
    ``tests/test_collective_fanout.py:512-527`` runs it.  MAP_SHARD and
    MAP_REPLICATE × MERGE_GATHER, MERGE_CONCAT and MERGE_SUM, with and
    without ``takes_index``.  Tolerance: exact for gather and concat; for
    sum, exact on integer-valued float32 and within 1e-6 relative on
    seeded normals (the JAX ``psum`` need not fold in fan-out order; the
    port's two legs fold alike and agree exactly).  MERGE_NONE keeps the
    client's rows and names the owner of a remote one.
  * Frame 21's body: the JAX keys with the same values for the same
    fan-out, plus the port's ``xrows``/``xrow_bytes``; frames 21-24 keep
    the JAX numbers.
  * Across processes (fresh interpreters): the JAX package's 2-process
    script (``tests/test_collective_fanout.py:611-720``) and the port's
    counterpart side by side.  With "auto" on the CPU the call declines
    ``xproc_uncompiled`` before any announce; forced "on" in the client
    only, the member counts ``announce_refused_xproc_uncompiled`` and the
    client ``degraded_announce_refused``: the routes and counters are equal
    in the two packages.  Then the port alone, with "on" in both: the
    route is ``collective``, the result ``op * 2``, ``member_entries``
    ticks; a contract mismatch refuses ``merge_mismatch``; a black-holed
    announce degrades, the entry the other member parked expires, and the
    waiters table is empty after the timeout.
"""
from __future__ import annotations

import json
import time
import threading
import types

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.channels import collective_fanout as jcf
from brpc_tpu.ici import fabric as jfab
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.channels import collective_fanout as tcf
from brpc_tpu_torch.ici import fabric as tfab
from brpc_tpu_torch.ici import ipc_pull
from brpc_tpu_torch.ici.mesh import IciMesh

from tests.torch_procs import REPO, ok, run_procs

N = 8
COLS = 16
CLIENT = frozenset({0, 1})
MEMBERS = {1: (2, 3), 2: (4, 5), 3: (6, 7)}     # pid -> its ranks
CASES = [(mapping, merge, ti) for mapping in ("shard", "replicate")
         for merge in ("gather", "concat", "sum") for ti in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def cpu_mesh():
    prev = IciMesh._default if hasattr(IciMesh, "_default") else None
    mesh = IciMesh(N, device="cpu")
    IciMesh.set_default(mesh)
    yield mesh
    IciMesh.set_default(prev)


class _Sock:
    """A member's (or the client's) fabric socket as the leg uses it: the
    importer of the peer's exports and the control channel."""

    failed = False

    def __init__(self):
        self._importer = ipc_pull.Importer()
        self.sent = []

    def _peer_gone(self):
        return False

    def _ctrl_send(self, ftype, body):
        self.sent.append((ftype, json.loads(body)))


def _body(ti):
    return (lambda i, x: x * 2.0 + i) if ti else (lambda x: x * 2.0)


def _operand(mapping, kind, seed=7):
    rng = np.random.default_rng(seed)
    shape = (N, COLS) if mapping == "shard" else (COLS,)
    if kind == "int":
        return rng.integers(-64, 64, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _port_xproc(name, op, monkeypatch, local=CLIENT, members=MEMBERS):
    """The port's cross-process execution in one process: the client's
    export, each member's pulls, bodies and exports, the client's pulls
    and merge; returns ``(result, the local leg's result)``."""
    md = tcf.registry().method(name)
    devs = tuple(range(N))
    plane = tcf.CollectiveFanoutPlane.instance()
    local_leg = plane._run_local(tcf._Lowering(name, md, devs,
                                               torch.from_numpy(op),
                                               md.mapping))
    monkeypatch.setattr(tcf, "_local_devices", lambda: local)
    owners = {p: d[0] for p, d in members.items()}
    low = tcf._Lowering(name, md, devs, op, md.mapping, "xproc", owners)
    call = tcf._XprocCall(low)
    msg = tcf.announce_body(low, 0, call)
    mlow = tcf._Lowering(name, md, tuple(msg["devices"]), None,
                         msg["mapping"], "xproc", {},
                         tuple(msg["shape"]), msg["dtype"])
    held = []
    try:
        for pid, ranks in members.items():
            sock = _Sock()
            rows, h = tcf.member_compute(sock, mlow, msg, frozenset(ranks))
            held += h
            call.commit(pid, sock, [devs.index(r) for r in ranks])
            call.on_result(pid, sock, True, {"rows": rows})
        out = plane._run_xproc(low, call)
    finally:
        call.finish()
        for exp, _t in held:
            exp.release()
    return out, local_leg


def _jax_xproc(name, op):
    import jax
    md = jcf.registry().method(name)
    low = jcf._Lowering(name, md, tuple(range(N)), op, md.mapping, "xproc",
                        {})
    fn, ga = jcf.CollectiveFanoutPlane.instance()._prepare_xproc(low)
    return np.asarray(jax.block_until_ready(fn(ga)))


@pytest.mark.parametrize("kind", ["int", "normal"])
@pytest.mark.parametrize("mapping,merge,ti", CASES)
def test_xproc_execution_equals_local_leg_and_jax(mapping, merge, ti, kind,
                                                  monkeypatch):
    name = f"XFan.{mapping}.{merge}.{int(ti)}"
    for mod in (jcf, tcf):
        mod.register_device_handler(name, _body(ti), merge=merge,
                                    mapping=mapping, takes_index=ti)
    op = _operand(mapping, kind)
    got, local_leg = _port_xproc(name, op, monkeypatch)
    want = _jax_xproc(name, op)
    assert tuple(got.shape) == want.shape
    # the port's two legs: one function, bit for bit
    assert torch.equal(got, local_leg)
    if merge == "sum" and kind == "normal":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert ipc_pull.live_segments() == []
    stats = tcf.xproc_stats()
    assert stats["orphans"] == stats["calls"] == 0


def test_merge_none_keeps_rows_with_their_owners(monkeypatch):
    name = "XFan.none"
    tcf.register_device_handler(name, lambda x: x + 1.0, merge="none")
    op = _operand("shard", "normal")
    got, local_leg = _port_xproc(name, op, monkeypatch)
    assert got.remote == {i: p for p, r in MEMBERS.items() for i in r}
    for i in CLIENT:
        assert torch.equal(got[i], local_leg[i])
        assert got.mesh.rank_of(got[i]) == i
    with pytest.raises(LookupError, match="process 2"):
        got[4]
    with pytest.raises(LookupError):
        got.stack()
    assert tuple(got.shape) == (N, COLS)


def test_rows_pulled_are_the_design_count(monkeypatch):
    """Each member pulls one scatter row per rank it owns; the client one
    result per remote rank."""
    name = "XFan.count"
    tcf.register_device_handler(name, lambda x: x * 3.0)
    before = tcf.xproc_stats()
    _port_xproc(name, _operand("shard", "int"), monkeypatch)
    after = tcf.xproc_stats()
    remote = sum(len(r) for r in MEMBERS.values())
    assert after["rows_pulled"] - before["rows_pulled"] == 2 * remote
    assert after["rows_exported"] - before["rows_exported"] == remote


def test_announce_body_and_frame_numbers_equal_jax(monkeypatch):
    for a in ("_F_COLL_CALL", "_F_COLL_OK", "_F_COLL_ERR", "_F_COLL_GO"):
        assert getattr(tfab, a) == getattr(jfab, a)
    assert {tfab._F_COLL_RESULT, tfab._F_COLL_FAIL,
            tfab._F_COLL_RELEASE}.isdisjoint(range(1, 40))
    name = "XFan.body"
    op = _operand("replicate", "int")
    captured = {}

    class Capture:
        failed = False

        def _peer_gone(self):
            return False

        def _ctrl_send(self, ftype, body):
            captured.setdefault(pkg, (ftype, json.loads(body)))

    tflags.set_flag("ici_fanout_xproc_timeout_s", 0.05)
    from brpc_tpu.butil import flags as jflags
    jflags.set_flag("ici_fanout_xproc_timeout_s", 0.05)
    try:
        for pkg, mod in (("jax", jcf), ("port", tcf)):
            mod.register_device_handler(name, lambda x: x, merge="sum",
                                        mapping="replicate")
            md = mod.registry().method(name)
            low = mod._Lowering(name, md, (0, 1, 2), op, "replicate",
                                "xproc", {1: 2})
            monkeypatch.setattr(mod, "_member_sock", lambda dev: Capture())
            args = (low, 5)
            if mod is tcf:
                monkeypatch.setattr(tcf, "_local_devices",
                                    lambda: frozenset({0, 1}))
                call = tcf._XprocCall(low)
                args += (call,)
            with pytest.raises(mod.CollectiveExecError) as e:
                mod.CollectiveFanoutPlane.instance()._announce_xproc(*args)
            assert e.value.reason == mod.R_ANNOUNCE
            if mod is tcf:
                call.finish()
    finally:
        tflags.set_flag("ici_fanout_xproc_timeout_s", 10.0)
        jflags.set_flag("ici_fanout_xproc_timeout_s", 10.0)
    (jt, jbody), (tt, tbody) = captured["jax"], captured["port"]
    assert jt == tt == tfab._F_COLL_CALL
    assert set(tbody) - set(jbody) == {"xrows", "xrow_bytes"}
    for k in ("method", "seq", "devices", "mapping", "merge", "shape",
              "dtype"):
        assert tbody[k] == jbody[k], k
    assert tbody["shape"] == [3, COLS]       # the stacked replicate shape
    assert len(tbody["xrows"]) == 3 and tbody["xrow_bytes"] == 4 * COLS
    assert tcf.xproc_stats()["waiters"] == 0
    assert ipc_pull.live_segments() == []


def test_collective_slow_is_the_ports_own_point(monkeypatch):
    """``plane_slow_ms={"collective": ms}``: the JAX package consults
    ``on_plane_op`` only for "device" and "shm", so its announce runs
    unslowed and its plan counts nothing; the port's announce sleeps once
    per member process (its own point, at the announce)."""
    name = "XFan.slow"
    op = _operand("replicate", "int")
    from brpc_tpu.butil import flags as jflags
    from brpc_tpu.rpc import fault_injection as jfi
    from brpc_tpu_torch.rpc import fault_injection as tfi

    class Capture:
        failed = False

        def _peer_gone(self):
            return False

        def _ctrl_send(self, ftype, body):
            pass

    out = {}
    tflags.set_flag("ici_fanout_xproc_timeout_s", 0.05)
    jflags.set_flag("ici_fanout_xproc_timeout_s", 0.05)
    try:
        for pkg, mod, fi in (("jax", jcf, jfi), ("port", tcf, tfi)):
            mod.register_device_handler(name, lambda x: x, merge="sum",
                                        mapping="replicate")
            md = mod.registry().method(name)
            low = mod._Lowering(name, md, (0, 1, 2), op, "replicate",
                                "xproc", {1: 2})
            monkeypatch.setattr(mod, "_member_sock", lambda dev: Capture())
            args = (low, 5)
            if mod is tcf:
                monkeypatch.setattr(tcf, "_local_devices",
                                    lambda: frozenset({0, 1}))
                call = tcf._XprocCall(low)
                args += (call,)
            plan = fi.FabricFaultPlan(plane_slow_ms={"collective": 300})
            asked = []
            orig = plan.on_plane_op
            monkeypatch.setattr(plan, "on_plane_op", lambda sock, plane: (
                asked.append(plane), orig(sock, plane))[1])
            t0 = time.monotonic()
            with fi.inject_fabric(plan):
                with pytest.raises(mod.CollectiveExecError):
                    mod.CollectiveFanoutPlane.instance()._announce_xproc(
                        *args)
            out[pkg] = (time.monotonic() - t0, asked,
                        plan.injected["plane_slow"])
            if mod is tcf:
                call.finish()
    finally:
        tflags.set_flag("ici_fanout_xproc_timeout_s", 10.0)
        jflags.set_flag("ici_fanout_xproc_timeout_s", 10.0)
    (jt, jasked, jslow), (tt, tasked, tslow) = out["jax"], out["port"]
    assert jasked == [] and jslow == 0 and jt < 0.3
    assert tasked == ["collective"] and tslow == 1 and tt >= 0.3
    # and the port's plan says so: "collective" is recorded as its own
    # point, not as one of the JAX package's
    doc = " ".join(tfi.__doc__.split())
    assert '"collective", one sleep per member at the fan-out\'s ' \
        "announce, is the port's own point" in doc
    plan_doc = " ".join(tfi.FabricFaultPlan.__doc__.split())
    assert "\"collective\" (a fan-out announce) is the port's own " \
        "point" in plan_doc


def test_an_orphaned_scatter_pin_goes_at_its_expiry():
    """A call that ends while a committed member has not reported keeps
    its scatter export for that member's pull, at most twice the timeout:
    the export is released at the expiry with no later call or stats read
    to sweep it."""
    released = []
    member = types.SimpleNamespace(failed=False, _peer_gone=lambda: False,
                                   _ctrl_send=lambda ft, body: None)
    call = tcf._XprocCall.__new__(tcf._XprocCall)
    call.uuid, call.cpid = 0x5EED, 0
    call._cv = threading.Condition(threading.Lock())
    call.committed, call.results = {1: member}, {}
    call.export = types.SimpleNamespace(release=lambda: released.append(1))
    call.full = None
    old = tflags.get_flag("ici_fanout_xproc_timeout_s")
    tflags.set_flag("ici_fanout_xproc_timeout_s", 0.1)
    try:
        call.finish()
        assert released == []                # member 1 may still pull
        deadline = time.monotonic() + 5
        while not released and time.monotonic() < deadline:
            time.sleep(0.01)
        assert released == [1]
    finally:
        tflags.set_flag("ici_fanout_xproc_timeout_s", old)


# ---------------------------------------------------------------------------
# Across processes.
# ---------------------------------------------------------------------------

_PORT_FANOUT = r"""
from brpc_tpu_torch.channels import collective_fanout as cf
from brpc_tpu_torch.ici.pod import Pod
from brpc_tpu_torch.rpc import fault_injection as fi
SHARD = 64
flags.set_flag("ici_fanout_reprobe_s", 0.2)
flags.set_flag("ici_fanout_xproc_timeout_s", 1.0)
MYDEV = 2 * pid

class FanSvc(rpc.Service):
    SERVICE_NAME = "Fan"
    def _b(self, cntl):
        x = np.frombuffer(cntl.request_attachment.to_bytes(), np.float32)
        cntl.response_attachment.append((x * 2.0).astype(np.float32).tobytes())
    @rpc.method(EchoRequest, EchoResponse)
    def Scale(self, cntl, request, response, done):
        self._b(cntl); done()
    @rpc.method(EchoRequest, EchoResponse)
    def Mis(self, cntl, request, response, done):
        self._b(cntl); done()

pod = Pod.join("xfan")
server = rpc.Server(rpc.ServerOptions(native_ici=False))
server.add_service(FanSvc())
server.register_collective("Fan.Scale", lambda x: x * 2.0)
# a contract registered otherwise in process 1 (a rolling upgrade)
server.register_collective("Fan.Mis", lambda x: x * 2.0,
                           merge="sum" if pid == 1 else "gather")
assert server.start("ici://%d" % MYDEV) == 0
pod.wait_epoch(4 * NPROC, timeout=60)
ms = pod.members(refresh=True)
assert all(sorted(ms[p].coll) == ["Fan.Mis", "Fan.Scale"]
           for p in range(NPROC)), {p: m.coll for p, m in ms.items()}
barrier("up")
out = {"foreign": foreign()}

def stats():
    return {k: v for k, v in route.collective_stats().items() if v}

if pid == 0:
    def mkpc(devs):
        pc = channels.ParallelChannel()
        mapper = channels.ShardingCallMapper()
        merger = channels.CollectiveMerger(merge="gather", dtype="float32",
                                           shard_shape=(SHARD,))
        for d in devs:
            ch = rpc.Channel()
            ch.init("ici://%d" % d,
                    options=rpc.ChannelOptions(timeout_ms=30000, max_retry=1))
            pc.add_channel(ch, mapper=mapper, merger=merger)
        return pc

    pc = mkpc((0, 2))
    op = np.arange(2 * SHARD, dtype=np.float32).reshape(2, SHARD)

    def call(pc, op, method="Fan.Scale"):
        cntl = rpc.Controller()
        cntl.fanout_operand = op
        t0 = time.monotonic()
        pc.call_method(method, cntl, EchoRequest(message="x"),
                       EchoResponse())
        assert not cntl.failed(), (cntl.error_code_, cntl.error_text)
        got = np.asarray(cntl.fanout_result)
        assert got.shape == op.shape and np.array_equal(got, op * 2.0)
        return cntl.fanout_route, time.monotonic() - t0

    # leg 1: "auto" on the CPU declines before any announce
    out["leg1"] = call(pc, op)[0]
    out["s1"] = stats()
    # leg 2: forced on in the client only: the member refuses
    flags.set_flag("ici_device_plane_xproc_compiled", "on")
    out["leg2"] = call(pc, op)[0]
    out["s2"] = stats()
    put("leg2_done", 1)
    # leg 3: on in the member too: the cross-process leg runs
    get("member_on")
    time.sleep(0.3)                      # announce_refused's reprobe
    out["leg3"] = call(pc, op)[0]
    out["leg3_tensor"] = call(pc, torch.from_numpy(op))[0]
    # leg 4: a contract mismatch in the member
    out["leg4"] = call(pc, op, "Fan.Mis")[0]
    out["s4"] = stats()
    time.sleep(0.3)
    # leg 5: process 1's announce black-holed; process 2 accepts, parks
    get("member2_on")                    # process 2 takes the leg too
    # the first call to process 2 dials its fabric socket: done here, not
    # inside the warm-up announce's 1 s timeout
    dial = rpc.Channel()
    dial.init("ici://4", options=rpc.ChannelOptions(timeout_ms=30000))
    c = rpc.Controller()
    c.request_attachment.append(np.zeros(SHARD, np.float32).tobytes())
    dial.call_method("Fan.Scale", c, EchoRequest(message="x"), EchoResponse)
    assert not c.failed(), c.error_text
    pc3 = mkpc((0, 2, 4))
    op3 = np.arange(3 * SHARD, dtype=np.float32).reshape(3, SHARD)
    out["leg5_warm"] = call(pc3, op3)[0]
    plan = fi.FabricFaultPlan(collective_drop_announces=1)
    with fi.inject_fabric(plan):
        out["leg5"], out["leg5_s"] = call(pc3, op3)
    out["leg5_injected"] = plan.injected["coll_announce_drop"]
    out["waiters_after"] = cf.xproc_stats()["waiters"]
    out["s5"] = stats()
    put("legs_done", 1)
else:
    get("leg2_done")
    out["s2"] = stats()
    flags.set_flag("ici_device_plane_xproc_compiled", "on")
    put("member_on" if pid == 1 else "member2_on", 1)
    get("legs_done")
    time.sleep(2.5)                      # twice the timeout, then a sweep
    out["xproc"] = cf.xproc_stats()
    out["s_end"] = stats()
barrier("done")
server.stop()
pod.leave()
result(out)
finish()
"""


def _jax_script():
    from tests.test_collective_fanout import _XPROC_FANOUT
    marker = 'kv.wait_at_barrier("fanout_done", 120000)'
    assert marker in _XPROC_FANOUT
    return _XPROC_FANOUT.replace(
        marker, 'print("STATS " + json.dumps({k: v for k, v in '
                'iroute.collective_stats().items() if v}), flush=True)\n'
                + marker) % {"repo": REPO}


@pytest.fixture(scope="module")
def two_packages():
    """Both packages' scenarios, run at once: the JAX pair in a thread."""
    from tests.test_pod import _run_pod
    jax_out = {}

    def run_jax():
        try:
            jax_out["outs"] = _run_pod(_jax_script(), n=2, timeout=240,
                                       tag="xproc_fanout_parity")
        except BaseException as e:          # reported by the test
            jax_out["error"] = e

    t = threading.Thread(target=run_jax)
    t.start()
    port = run_procs(_PORT_FANOUT, 3, timeout=180)
    t.join(300)
    return jax_out, port


def _jax_stats(text):
    line = [ln for ln in text.splitlines() if ln.startswith("STATS ")][-1]
    return json.loads(line[6:])


def test_two_process_decline_and_refusal_equal_jax(two_packages):
    jax_out, port = two_packages
    if "error" in jax_out:
        raise jax_out["error"]
    p0, p1, _p2 = ok(port)
    j0, j1 = (_jax_stats(t) for t in jax_out["outs"])
    # the JAX client: a decline at the screen, then a refused announce
    assert p0["leg1"] == p0["leg2"] == "rpc"
    assert p0["s1"] == {"collective_ineligible_xproc_uncompiled": 1}
    assert p0["s2"] == j0, (p0["s2"], j0)
    assert j0 == {"collective_ineligible_xproc_uncompiled": 1,
                  "collective_degraded_announce_refused": 1}
    assert p1["s2"] == j1 == {
        "collective_announce_refused_xproc_uncompiled": 1}
    assert all(r["foreign"] == [] for r in ok(port))


def test_forced_on_in_both_runs_the_leg(two_packages):
    _jax, port = two_packages
    p0, p1, p2 = ok(port)
    assert p0["leg3"] == p0["leg3_tensor"] == "collective"
    assert p1["s_end"]["collective_member_entries"] >= 2
    assert p1["xproc"]["member_entries_run"] >= 2
    # each member pulled its one row per entry; nothing is left held
    assert p1["xproc"]["rows_pulled"] == p1["xproc"]["member_entries_run"]
    for r in (p1, p2):
        assert {k: r["xproc"][k] for k in ("parked", "held", "queued")} \
            == {"parked": 0, "held": 0, "queued": 0}


def test_contract_mismatch_refuses_merge_mismatch(two_packages):
    _jax, port = two_packages
    p0, p1, _p2 = ok(port)
    assert p0["leg4"] == "rpc"
    assert p1["s_end"]["collective_announce_refused_merge_mismatch"] == 1
    assert p0["s4"]["collective_degraded_announce_refused"] == 2


def test_black_holed_announce_degrades_and_parked_entries_expire(
        two_packages):
    _jax, port = two_packages
    p0, p1, p2 = ok(port)
    assert p0["leg5_warm"] == "collective"
    assert p0["leg5"] == "rpc" and p0["leg5_injected"] == 1
    assert p0["leg5_s"] < 1.0 + 1.0          # the timeout, then the loop
    assert p0["s5"]["collective_degraded_announce_refused"] == 3
    assert p0["waiters_after"] == 0
    # process 2 accepted and parked; its entry expired unused
    assert p2["s_end"].get("collective_member_entry_expired") == 1
    assert "collective_member_entry_expired" not in p1["s_end"]


def test_phase19_rehearsal_on_the_cpu():
    """``chip_smoke.py`` phase 19 at a small size on the CPU (the leg
    forced on): four members, the client's (a)-(c) and the members'
    counts; its own checks hold (launches = rows pulled + loop copies in
    every process, 6 and 2 rows a call, the SIGKILL leg, nothing left)."""
    import chip_smoke as cs
    saved = (cs.XPROC_SHARD, cs.XPROC_CALLS, cs.XPROC_BIG,
             cs.XPROC_BIG_CALLS, cs.POD_TIMEOUT_S)
    cs.XPROC_SHARD, cs.XPROC_CALLS, cs.XPROC_BIG = 64, 8, 1 << 20
    cs.XPROC_BIG_CALLS, cs.POD_TIMEOUT_S = 2, 150.0
    try:
        out = cs.phase_fanout_xproc(device="cpu")
    finally:
        (cs.XPROC_SHARD, cs.XPROC_CALLS, cs.XPROC_BIG, cs.XPROC_BIG_CALLS,
         cs.POD_TIMEOUT_S) = saved
    calls = out["compiled_calls_ab"]
    assert calls == 1 + 8 + 2 * (1 + 2)
    assert [out["ab_counts"][q]["rows_pulled"] for q in range(4)] == \
        [6 * calls] + [2 * calls] * 3
    assert out["c"]["kill"]["routes"] == ["rpc", "rpc", "rpc", "collective"]
    assert out["c"]["survivors"]["route"] == "collective"
    assert sorted(out["final_counts"]) == [0, 2, 3]


def test_merger_reads_a_cut_device_answer_on_the_device():
    """A degraded call's answer over the fabric read's 64 MiB cut arrives
    as several refs of one DEVICE block: the merger takes it as one view
    of that block (before, it took the host-bytes path, a round trip
    through the host that cost a 64 MiB sum about 1.2 s on the card)."""
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.channels.collective_fanout import CollectiveMerger
    x = torch.arange(64, dtype=torch.float32)
    src = IOBuf()
    src.append_device_array(x.view(torch.uint8))
    att = src.cut(100)                 # two refs of the one block
    att.append(src)
    assert len(att.device_refs()) == 2
    part = CollectiveMerger("sum", "float32", (64,))._part(att)
    assert torch.equal(part, x)
    assert part.untyped_storage().data_ptr() == \
        x.untyped_storage().data_ptr()          # a view, no copy
    other = IOBuf()
    other.append_device_array(torch.zeros(8, dtype=torch.uint8))
    other.append_device_array(torch.ones(8, dtype=torch.uint8))
    both = CollectiveMerger("gather", "uint8", (16,))._part(other)
    assert both.tolist() == [0] * 8 + [1] * 8
