"""Pod membership on both packages (``brpc_tpu.ici.pod`` and
``brpc_tpu_torch.ici.pod``), then the port's pod across processes.

In process: the same sequence of join / advertise / mark_draining /
withdraw / publish_collective / publish_load / leave / rejoin through the
JAX ``Pod`` and the port's, each member on a fake node over an in-memory
store (the JAX package's coordination KV, the port's ``TCPStore``
surface): equal records (``ts`` aside), epochs and ``serving_endpoints``
after every step.  The unit tests of ``tests/test_pod.py:103-130`` on
both packages; the ``pod://`` router and the autoscaler's pod hooks on
both; the fabric sequencer's epoch stamp and the server hooks.

Across processes (fresh interpreters on a CPU mesh, the fabric's store on
``127.0.0.1``), the port alone, through ``brpc_tpu_torch.tools.pod_peer``
(``chip_smoke.py`` phase 18 rehearsed at a small size, its own checks
included): three members run the
disaggregated Generate (each answer equal to ``reference_generate``, the
trace stitched from process 0 holding the JAX test's span set), the
decode's drain and restart seen through ``pod://pd``, epochs equal
everywhere; four members run ``tests/test_pod.py``'s kill-and-drain
contract with DEVICE attachments.  No child loads JAX, and none leaves a
segment.  Tolerance: exact equality throughout.
"""
from __future__ import annotations

import json
import threading
import types

import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.channels import collective_fanout as jcf
from brpc_tpu.ici import pod as jpod
from brpc_tpu.policy import naming as jnaming
from brpc_tpu.serving import autoscaler as jauto
from brpc_tpu.serving import router as jrouter
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch.butil.endpoint import parse_endpoint as tparse
from brpc_tpu_torch.channels import collective_fanout as tcf
from brpc_tpu_torch.ici import fabric as tfab
from brpc_tpu_torch.ici import ipc_pull as tipc
from brpc_tpu_torch.ici import pod as tpod
from brpc_tpu_torch.ici.mesh import IciMesh as TMesh
from brpc_tpu_torch.policy import naming as tnaming
from brpc_tpu_torch.serving import autoscaler as tauto
from brpc_tpu_torch.serving import router as trouter

NPROC = 3


@pytest.fixture(scope="module", autouse=True)
def drained():
    """No pod stays joined, and the port's sockets close, after the
    module."""
    yield
    for mod in (jpod, tpod):
        mod.Pod._instance = None
    from brpc_tpu_torch import rpc
    import time
    deadline = time.monotonic() + 2.0
    while rpc.list_sockets() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()


@pytest.fixture(autouse=True)
def no_collectives(monkeypatch):
    """A join reads the fan-out registry: other tests in the worker may
    have registered methods there, so each package's reads as empty."""
    empty = types.SimpleNamespace(method_names=lambda: [])
    monkeypatch.setattr(jcf, "registry", lambda: empty)
    monkeypatch.setattr(tcf, "registry", lambda: empty)


# ---- fake nodes --------------------------------------------------------

class _JaxKv:
    """The JAX coordination service's KV surface the pod uses."""

    def __init__(self):
        self.d = {}

    def key_value_set(self, key, value, allow_overwrite=False):
        self.d[key] = value

    def key_value_dir_get(self, prefix):
        return [(k, v) for k, v in sorted(self.d.items())
                if k.startswith(prefix)]


class _Store:
    """The ``TCPStore`` surface the port's pod uses."""

    def __init__(self):
        self.d = {}
        self.round_trips = 0

    def set(self, key, value):
        self.d[key] = value.encode() if isinstance(value, str) else value

    def check(self, keys):
        self.round_trips += 1
        return all(k in self.d for k in keys)

    def multi_get(self, keys):
        self.round_trips += 1
        return [self.d[k] for k in keys]


def _jax_node(pid, kv):
    return types.SimpleNamespace(process_id=pid, _kv=kv,
                                 ctrl_addr=f"127.0.0.1:{9000 + pid}")


def _port_node(pid, store, mesh):
    # the JAX node's devices: the test process's 8 CPU devices all belong
    # to JAX process 0
    return types.SimpleNamespace(
        process_id=pid, num_processes=NPROC, _store=store,
        _store_lock=threading.Lock(), ctrl_addr=f"127.0.0.1:{9000 + pid}",
        devices=list(range(8)) if pid == 0 else [], mesh=mesh)


def _record(raw):
    d = json.loads(raw)
    d.pop("ts")
    return d


class _Both:
    """Each package's pods, one per member, over one store each."""

    def __init__(self):
        self.jkv = _JaxKv()
        self.store = _Store()
        self.mesh = TMesh(ranks=8, device="cpu")
        self.pods = {"jax": {}, "port": {}}

    def join(self, pid):
        for name, mod, node in (
                ("jax", jpod, _jax_node(pid, self.jkv)),
                ("port", tpod, _port_node(pid, self.store, self.mesh))):
            p = mod.Pod("seq", node)
            p._join()
            self.pods[name][pid] = p

    def do(self, pid, op, *args):
        for name in ("jax", "port"):
            getattr(self.pods[name][pid], op)(*args)

    def state(self):
        out = {}
        for name in ("jax", "port"):
            raw = (self.jkv.d if name == "jax"
                   else {k: v.decode() for k, v in self.store.d.items()})
            recs = {k: _record(v) for k, v in sorted(raw.items())}
            views = {pid: (p.epoch(refresh=True),
                           [(str(ep), owner)
                            for ep, owner in p.serving_endpoints()])
                     for pid, p in sorted(self.pods[name].items())}
            out[name] = (recs, views)
        return out

    def close(self):
        for name in ("jax", "port"):
            for p in self.pods[name].values():
                p._stop.set()
                t = p._watch_thread
                if t is not None:
                    t.join(2.0)


_SEQUENCE = [
    ("join", 0), ("join", 1), ("advertise", 0, 0), ("advertise", 1, 2),
    ("advertise", 0, 1), ("advertise", 0, 1), ("mark_draining", 1, 2),
    ("mark_draining", 1, 2), ("publish_collective", 0, ["Fan.Scale"]),
    ("publish_collective", 0, ["Fan.Scale"]), ("publish_load", 0, 0.5),
    ("publish_load", 0, 1.7), ("withdraw", 1, 2), ("withdraw", 1, 2),
    ("leave", 1), ("join", 1), ("advertise", 1, 3), ("join", 2),
    ("advertise", 2, 4), ("withdraw", 0, 1), ("mark_draining", 0, 0),
    ("advertise", 0, 0), ("leave", 2), ("leave", 0), ("join", 0),
]


def test_transition_sequence_equals_jax():
    """Every step of the sequence leaves both packages with the same
    records (``ts`` aside), the same epoch in every member and the same
    ``serving_endpoints``."""
    both = _Both()
    try:
        for step in _SEQUENCE:
            op, pid, *args = step
            if op == "join":
                both.join(pid)
            else:
                both.do(pid, op, *args)
            st = both.state()
            assert st["jax"] == st["port"], step
        recs, views = both.state()["port"]
        assert set(e for e, _ in views.values()) == {
            sum(r["gen"] for r in recs.values())}
        # a rejoin resumed the surviving record's gen (join, advertise,
        # drain mark, withdraw, leave: 5, then the rejoin and an
        # advertise): the epoch never regressed
        assert recs["brpc_tpu/pod/seq/1"]["gen"] == 7
    finally:
        both.close()


def test_steady_watch_poll_is_one_round_trip():
    """Once every process's record is known, a refresh reads the pod in
    one store round trip (a ``multi_get``)."""
    store = _Store()
    mesh = TMesh(ranks=8, device="cpu")
    pods = [tpod.Pod("rt", _port_node(pid, store, mesh))
            for pid in range(NPROC)]
    for p in pods:
        p._publish()
    pods[0]._refresh()
    store.round_trips = 0
    members = pods[0]._refresh()
    assert sorted(members) == list(range(NPROC))
    assert store.round_trips == 1


# ---- tests/test_pod.py:103-130 on both packages ------------------------

@pytest.mark.parametrize("mod", [jpod, tpod], ids=["jax", "port"])
def test_epoch_is_sum_of_gens_and_strictly_monotone(mod):
    m = {0: mod.PodMember(0, 1, mod.UP, [0, 1], [0], []),
         1: mod.PodMember(1, 2, mod.UP, [2, 3], [2], [])}
    assert mod.epoch_of(m) == 3
    m[1] = mod.PodMember(1, 3, mod.DOWN, [2, 3], [], [])
    assert mod.epoch_of(m) == 4
    m[2] = mod.PodMember(2, 1, mod.UP, [4, 5], [4], [])
    assert mod.epoch_of(m) == 5


@pytest.mark.parametrize("mod", [jpod, tpod], ids=["jax", "port"])
def test_member_record_roundtrip(mod):
    m = mod.PodMember(3, 7, mod.DRAINING, [6, 7], [6], [6], ctrl="h:1")
    m2 = mod.PodMember.from_json(m.to_json())
    assert (m2.pid, m2.gen, m2.state, m2.devices, m2.serving,
            m2.draining, m2.ctrl) == (3, 7, mod.DRAINING, [6, 7], [6],
                                      [6], "h:1")


def test_member_json_equals_jax():
    args = (3, 7, "draining", [6, 7], [6], [6])
    kw = dict(ctrl="h:1", ts=12.5, coll=["Fan.Scale"], load=0.25)
    assert jpod.PodMember(*args, **kw).to_json() == \
        tpod.PodMember(*args, **kw).to_json()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_join_requires_fabric_node(pkg, monkeypatch):
    if pkg == "jax":
        from brpc_tpu.ici.fabric import FabricNode
        if FabricNode.instance() is not None:
            pytest.skip("fabric initialized in this process")
        mod = jpod
    else:
        monkeypatch.setattr(tfab.FabricNode, "_instance", None)
        mod = tpod
    with pytest.raises(RuntimeError):
        mod.Pod.join("nope")


@pytest.mark.parametrize("naming", [jnaming, tnaming], ids=["jax", "port"])
def test_pod_naming_empty_without_join(naming):
    ns = naming.create_naming_service("pod://unjoined")
    assert ns.get_servers() == []


# ---- pod:// in the router, the autoscaler's pod hooks -------------------

class _FakePod:
    def __init__(self, name, endpoints):
        self.name = name
        self.endpoints = endpoints

    def serving_endpoints(self):
        return list(self.endpoints)


def test_router_follows_pod_membership_like_jax(monkeypatch):
    """``LoadAwareRouter("pod://r")`` in both packages: the refresher
    thread makes the balancer's members the pod's serving endpoints,
    ``describe`` names the url, and ``close`` joins the thread."""
    import brpc_tpu.butil.endpoint as jep
    eps = {"jax": jep.parse_endpoint, "port": tparse}
    fakes = {}
    for name, mod in (("jax", jpod), ("port", tpod)):
        fakes[name] = _FakePod("r", [(eps[name]("ici://2"), 1),
                                     (eps[name]("ici://4"), 2)])
        monkeypatch.setattr(mod.Pod, "_instance", fakes[name])
    routers = {"jax": jrouter.LoadAwareRouter("pod://r",
                                              refresh_interval_s=0.02),
               "port": trouter.LoadAwareRouter("pod://r",
                                               refresh_interval_s=0.02)}
    try:
        got = {k: sorted(r.targets()) for k, r in routers.items()}
        assert got["jax"] == got["port"] == ["ici://2", "ici://4"]
        for name in ("jax", "port"):
            fakes[name].endpoints = [(eps[name]("ici://4"), 2),
                                     (eps[name]("ici://6"), 3)]
        import time
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and any(
                sorted(r.targets()) != ["ici://4", "ici://6"]
                for r in routers.values()):
            time.sleep(0.01)
        got = {k: sorted(r.targets()) for k, r in routers.items()}
        assert got["jax"] == got["port"] == ["ici://4", "ici://6"]
        assert routers["jax"].describe()["naming"] == \
            routers["port"].describe()["naming"] == "pod://r"
    finally:
        for r in routers.values():
            r.close()
    assert routers["port"]._refresher is None
    assert not any(t.name == "serving_router_refresh" and t.is_alive()
                   for t in threading.enumerate())


def test_autoscaler_pod_hooks_equal_jax():
    """``pod=``: the autoscaler attaches to the pod, each tick publishes
    the load into the member record (no gen bump), and ``describe`` of
    the pod carries the autoscaler's block — in both packages alike."""
    both = _Both()
    try:
        both.join(0)
        loads = iter([0.9, 0.9, 0.1])
        seq = [next(loads) for _ in range(3)]
        scalers = {}
        for name, mod in (("jax", jauto), ("port", tauto)):
            it = iter(seq)
            scalers[name] = mod.LoadThresholdAutoscaler(
                lambda it=it: next(it), lambda: 1, lambda: True,
                lambda: True, options=mod.AutoscalerOptions(
                    samples_to_scale=2, max_size=2),
                pod=both.pods[name][0])
        for i in range(3):
            acts = {k: s.tick(now=10.0 * i) for k, s in scalers.items()}
            assert acts["jax"] == acts["port"]
            st = both.state()
            assert st["jax"] == st["port"]
        recs, _ = both.state()["port"]
        assert recs["brpc_tpu/pod/seq/0"]["load"] == 0.1
        assert recs["brpc_tpu/pod/seq/0"]["gen"] == 1
        descs = {k: both.pods[k][0].describe() for k in ("jax", "port")}
        assert descs["jax"]["autoscaler"] == descs["port"]["autoscaler"]
        assert descs["jax"] == descs["port"]
        assert both.pods["port"][0].loads() == {0: 0.1}
    finally:
        both.close()


def test_sequencer_stamps_the_pod_epoch(monkeypatch):
    """A fabric socket's device-plane sequencer takes the pod's epoch at
    its creation (0 with no pod)."""
    store = _Store()
    pod = tpod.Pod("e", _port_node(0, store, TMesh(ranks=8, device="cpu")))
    pod._gen, pod._state = 6, tpod.UP
    pod._publish()
    pod._refresh()

    def stub():
        return types.SimpleNamespace(
            _dplane_lock=threading.Lock(), _dplane_closed=False,
            _dplane_seq=None, is_server_side=True, remote_dev=5)

    monkeypatch.setattr(tpod.Pod, "_instance", None)
    s0 = stub()
    seq0 = tfab.FabricSocket._dplane_sequencer(s0)
    monkeypatch.setattr(tpod.Pod, "_instance", pod)
    s1 = stub()
    seq1 = tfab.FabricSocket._dplane_sequencer(s1)
    try:
        assert seq0.epoch == 0
        assert seq1.epoch == 6 == pod.epoch()
        assert seq1.describe()["epoch"] == 6
    finally:
        for q in (seq0, seq1):
            q.close()
            q.join()


def test_server_hooks_move_the_record(monkeypatch):
    """The server's start, drain and stop hooks advertise, mark and
    withdraw an ``ici://k`` rank; a ``mem://`` endpoint or no pod is a
    no-op."""
    store = _Store()
    pod = tpod.Pod("h", _port_node(0, store, TMesh(ranks=8, device="cpu")))
    monkeypatch.setattr(tpod.Pod, "_instance", None)
    tpod.on_server_started(tparse("ici://3"))
    assert pod._gen == 0
    monkeypatch.setattr(tpod.Pod, "_instance", pod)
    tpod.on_server_started(tparse("mem://x"))
    assert pod._gen == 0
    tpod.on_server_started(tparse("ici://3"))
    tpod.on_server_draining(tparse("ici://3"))
    pod._refresh()
    assert pod.serving_endpoints() == []
    tpod.on_server_stopped(tparse("ici://3"))
    m = pod.members(refresh=True)[0]
    assert (m.gen, m.serving, m.draining) == (3, [], [])


# ---- the port's pod across processes -----------------------------------

@pytest.fixture(scope="module")
def phase18():
    """``chip_smoke.py`` phase 18 rehearsed on the CPU at a small size (the
    skill's recipe): its own checks hold, and the members' results come
    back for the tests below."""
    import chip_smoke as cs
    saved = (cs.POD_SEQ, cs.POD_STEPS, cs.POD_PROMPTS, cs.POD_WARMUP,
             cs.POD_TIMEOUT_S)
    cs.POD_SEQ, cs.POD_STEPS, cs.POD_PROMPTS, cs.POD_WARMUP = 96, 4, 4, 1
    cs.POD_TIMEOUT_S = 150.0
    try:
        out = cs.phase_pod(device="cpu")
    finally:
        (cs.POD_SEQ, cs.POD_STEPS, cs.POD_PROMPTS, cs.POD_WARMUP,
         cs.POD_TIMEOUT_S) = saved
    for r in out["members"]["generate"] + out["members"]["chaos"]:
        assert r["foreign"] == []
        assert r["leaks"] == {"active": 0, "mapped": 0, "segments": 0}
        assert tipc.segments_on_disk(r["os_pid"]) == []
    return out


def test_three_process_pod_generate_trace_and_drain(phase18):
    """Three members: ``pod://pd`` lists their ranks; the Generates equal
    the reference, the KV handoffs crossed as kind 4 (decode launches =
    received = attachments); one ``/rpcz?trace_id=`` on process 0 holds
    the JAX test's eight spans and the transfer pair in causal order
    within the clock bounds; the pod-scope pages list every process; the
    decode's drain drops ``ici://4`` from ``pod://pd`` and its restart
    lists it again; every member reads epoch 9."""
    rs = phase18["members"]["generate"]
    p0 = rs[0]
    lists = [r["pod_list"] for r in rs]
    assert lists == [["ici://0", "ici://2", "ici://4"]] * 3, lists
    a, b, c = p0["a"], p0["b"], p0["c"]
    assert a["errors"] == [] and p0["errors"] == [], (a["errors"],
                                                      p0["errors"])
    assert a["generates"] == 5, a["generates"]
    hand = (a["handoff_bytes"], a["handoff_expected"], 5 * 96 * 1024)
    assert hand[0] == hand[1] == hand[2], hand
    dec = a["decode"]
    assert dec["launches"] == dec["received"] == dec["attachments"] == 5, dec
    assert a["router"]["launches"] == a["prefill"]["launches"] == 0, (
        a["router"], a["prefill"])
    assert b["problems"] == [], (b["problems"], b["span_count"],
                                 b["processes"])
    assert b["span_count"] >= 10, (b["span_count"], b["processes"])
    assert set(b["clock"]) == {"1", "2"}, b["clock"]
    assert all(v["bound_us"] > 0 for v in b["clock"].values()), b["clock"]
    assert b["vars_processes"] == [0, 1, 2] and not b["vars_unreachable"], (
        b["vars_processes"], b["vars_unreachable"], b.get("vars_errors"))
    assert b["metrics_processes"] == [0, 1, 2] and b["metrics_typed"], (
        b["metrics_processes"], b["metrics_typed"], b.get("metrics_errors"))
    assert c["dropped_s"] is not None and c["relisted_s"] is not None, c
    assert c["generate_after_restart_ok"] is True, (c, p0["errors"])
    epochs = [r["epoch"] for r in rs]
    assert epochs == [9, 9, 9], (epochs, [r.get("drain_s") for r in rs])
    n = phase18["launches_by_scenario"]["generate"]
    assert n == 5, (n, [r.get("a") for r in rs])


def test_four_process_kill_and_drain_under_traffic(phase18):
    """``tests/test_pod.py``'s N=4 contract on the port, each call with a
    64 KiB DEVICE attachment: no call fails through process 2's kill and
    process 3's drain, both revive into ``pod://chaos``, the pre-kill
    socket id is revoked, and every member reads epoch 12; in each
    process the copy launches equal the transfers it received."""
    rs = phase18["members"]["chaos"]
    for r in rs:
        p = r["pid"]
        assert r["failed"] == 0, (p, r["failures"])
        assert r["epoch"] == r["expected_epoch"] == 12, (
            p, r["epoch"], r["expected_epoch"])
        d = r["counts"]
        assert d["launches"] == d["copies"], (p, d)
        assert d["remote_received"] > 0, (p, d)
        assert r["unlisted_at"] is not None, (p, r["unlisted_at"],
                                              r["drain_mark"])
        assert r["unlisted_at"] >= r["drain_mark"], (
            p, r["unlisted_at"], r["drain_mark"])
    assert rs[0]["old_socket_revoked"] is True, rs[0]["old_socket_revoked"]
    assert rs[3]["drain_s"] < 4.0, rs[3]["drain_s"]


@pytest.mark.slow
def test_six_process_kill_and_drain_under_traffic():
    """``tests/test_pod.py:738-744`` on the port: the N=4 contract at N=6,
    four surviving members carrying the traffic through process 2's kill
    and process 3's drain; every member reads epoch 2*6 + 4 = 16.  Phase
    18's chaos leg (``chip_smoke.phase_pod``) with six members, on the
    CPU only."""
    import chip_smoke as cs
    out = cs.phase_pod(device="cpu", scenarios=("chaos",), chaos_procs=6)
    rs = out["members"]["chaos"]
    assert len(rs) == 6
    for r in rs:
        p = r["pid"]
        assert r["failed"] == 0, (p, r["failures"])
        assert r["epoch"] == r["expected_epoch"] == 16, (
            p, r["epoch"], r["expected_epoch"])
        d = r["counts"]
        assert d["launches"] == d["copies"], (p, d)
        assert d["remote_received"] > 0, (p, d)
        assert r["unlisted_at"] is not None, (p, r["unlisted_at"])
        assert r["unlisted_at"] >= r["drain_mark"], (
            p, r["unlisted_at"], r["drain_mark"])
        assert r["foreign"] == [], (p, r["foreign"])
        assert tipc.segments_on_disk(r["os_pid"]) == []
    assert rs[0]["old_socket_revoked"] is True, rs[0]["old_socket_revoked"]
    assert rs[3]["drain_s"] < 4.0, rs[3]["drain_s"]
    assert out["launches_by_scenario"] == {
        "generate": 0, "chaos": sum(r["counts"]["launches"] for r in rs)}


# ---- kind 4 both ways on one socket pair -------------------------------

_XPROC_BIDIR = r"""
from brpc_tpu_torch.tools.overload_clients import attachment_tensor
flags.set_flag("ici_device_plane_threshold", 4096)
N = 128 * 1024
K = 6
MYDEV = 2 * pid
PEERDEV = 2 * (1 - pid)

class Echo(rpc.Service):
    SERVICE_NAME = "Echo"
    @rpc.method(EchoRequest, EchoResponse)
    def Bounce(self, cntl, request, response, done):
        data = attachment_tensor(cntl.request_attachment)
        back = ((data.to(torch.int64) + 1) % 251).to(torch.uint8)
        # a DEVICE answer: the response rides kind 4 too, both directions
        # sequenced on ONE socket pair
        cntl.response_attachment.append_device_array(mesh.own(back, MYDEV))
        response.message = "ok"
        done()

server = rpc.Server(rpc.ServerOptions(native_ici=False))
server.add_service(Echo())
assert server.start("ici://%d" % MYDEV) == 0
barrier("up")
ch = rpc.Channel()
ch.init("ici://%d" % PEERDEV,
        options=rpc.ChannelOptions(timeout_ms=60000, max_retry=0))
errs = []

def fire(i):
    val = (i * 7 + pid * 3 + 1) % 251
    payload = mesh.own(torch.full((N,), val, dtype=torch.uint8), MYDEV + 1)
    cntl = rpc.Controller()
    cntl.request_attachment.append_device_array(payload)
    ch.call_method("Echo.Bounce", cntl, EchoRequest(message=str(i)),
                   EchoResponse)
    if cntl.failed():
        errs.append((i, cntl.error_code_, cntl.error_text))
        return
    got = attachment_tensor(cntl.response_attachment)
    if not bool((got == (val + 1) % 251).all()):
        errs.append((i, "corrupt", int(got[0])))

# both directions at once: two threads of K calls in each process
threads = [threading.Thread(target=lambda lo=lo: [fire(i) for i in
                                                  range(lo, lo + K)])
           for lo in (0, K)]
for t in threads:
    t.start()
for t in threads:
    t.join()
# both processes' calls are done, so both connections exist: a process
# whose own calls end first must not look for the peer's socket before
# the peer's handshake (its ring's set-up included) has landed
barrier("fired", 60)
socks = fabric_socks()
clients = [s for s in socks if not s.is_server_side]
servers = [s for s in socks if s.is_server_side]
c, s = clients[0], servers[0]
end = time.time() + 30
while (len(c._dplane_seq.executed) < 4 * K
       or len(s._dplane_seq.executed) < 4 * K) and time.time() < end:
    time.sleep(0.02)
put("order_s_%d" % pid, list(s._dplane_seq.executed))
out = {"errs": errs[:5], "clients": len(clients), "servers": len(servers),
       "c_executed": list(c._dplane_seq.executed),
       "s_executed": list(s._dplane_seq.executed),
       "peer_s": get("order_s_%d" % (1 - pid)),
       "c_master": c._dplane_seq.master, "s_master": s._dplane_seq.master,
       "c_sent": c.dplane_bytes_sent, "c_recv": c.dplane_bytes_recv,
       "foreign": foreign()}
barrier("done")
ch.close()
server.stop()
result(out)
finish()
"""


def test_xproc_bidirectional_total_order_and_byte_exactness():
    """``tests/test_pod.py:313-412`` on the port: device payloads both ways
    on one socket pair at once execute in ONE identical total order in the
    two processes (each client socket's order equals the peer's server
    socket's), byte-exact; every request and every answer crossed as kind
    4 (the IPC pull's plain carrier here)."""
    from tests.torch_census import debug_layers
    from tests.torch_procs import ok, run_procs
    k, n = 6, 128 * 1024
    # both processes under both runtime layers, their reports asserted
    with debug_layers() as layers:
        res = run_procs(layers.body(_XPROC_BIDIR, "bidir"), 2, timeout=120)
        rs = ok(res)
        assert len(layers.check("bidir", res)) == 2
    for r in rs:
        assert r["errs"] == []
        assert r["clients"] == r["servers"] == 1
        assert len(r["c_executed"]) == len(r["s_executed"]) == 4 * k
        assert r["c_master"] is False and r["s_master"] is True
        assert r["c_sent"] >= 2 * k * n and r["c_recv"] >= 2 * k * n
        assert r["c_executed"] == r["peer_s"], "the total order diverged"
        assert r["foreign"] == []


# ---- N=4 membership: join, resolve, reach, drain and restart -----------

_POD_MEMBERSHIP = r"""
from brpc_tpu_torch.ici.pod import Pod, epoch_of
from brpc_tpu_torch.policy.naming import create_naming_service
MYDEV = 2 * pid
pod = Pod.join("dryrun")

class Svc(rpc.Service):
    SERVICE_NAME = "EchoService"
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "m%d" % pid
        done()

server = rpc.Server(); server.add_service(Svc())
assert server.start("ici://%d" % MYDEV) == 0
pod.wait_epoch(2 * NPROC, timeout=30)        # join xN + advertise xN
out = {"foreign": foreign()}
# pod:// resolves every member's serving rank, the same everywhere
out["eps"] = sorted(str(e.endpoint) for e in
                    create_naming_service("pod://dryrun").get_servers())
# a balanced channel over the pod reaches every member
ch = rpc.Channel()
ch.init("pod://dryrun", "rr",
        options=rpc.ChannelOptions(timeout_ms=10000, max_retry=2))
seen, fails = set(), []
deadline = time.time() + 30
while len(seen) < NPROC and time.time() < deadline:
    cntl = rpc.Controller()
    resp = ch.call_method("EchoService.Echo", cntl,
                          EchoRequest(message="x"), EchoResponse)
    if cntl.failed():
        fails.append((cntl.error_code_, cntl.error_text))
        continue
    seen.add(resp.message)
out["seen"], out["fails"] = sorted(seen), fails[:3]
# one member drains and restarts: every member sees the epoch move
barrier("pm_resolved", 30)
if pid == NPROC - 1:
    server.stop(2.0)                         # drain mark + withdraw
    server2 = rpc.Server(); server2.add_service(Svc())
    assert server2.start("ici://%d" % MYDEV) == 0
    live_server = server2
else:
    live_server = server
FINAL = 2 * NPROC + 3                        # + drain, withdraw, advertise
out["waited"] = pod.wait_epoch(FINAL, timeout=30)
final = pod.members(refresh=True)
out["epoch"] = epoch_of(final)
out["serving"] = {str(p): final[p].serving for p in sorted(final)}
barrier("pm_done", 30)
ch.close()
live_server.stop()
pod.leave()
result(out)
finish()
"""


def test_pod_membership_join_resolve_drain_restart_n4():
    """``tests/test_pod.py::test_pod_membership_join_resolve_drain_
    restart_n4`` on the port: four processes join, ``pod://`` resolves
    every member's serving rank the same in each, an ``rr`` channel over
    it reaches all four, and one member's ``stop(2.0)`` and restart move
    the epoch to 2N+3 everywhere, each member serving its rank again."""
    from tests.torch_census import debug_layers
    from tests.torch_procs import ok, run_procs
    n = 4
    # every member under both runtime layers, its reports asserted
    with debug_layers() as layers:
        res = run_procs(layers.body(_POD_MEMBERSHIP, "pod"), n,
                        timeout=120)
        rs = ok(res)
        assert len(layers.check("pod", res)) == n
    want = sorted(f"ici://{2 * p}" for p in range(n))
    for r in rs:
        assert r["foreign"] == []
        assert r["eps"] == want
        assert r["seen"] == sorted(f"m{p}" for p in range(n)), r["fails"]
        assert r["epoch"] == 2 * n + 3
        assert r["serving"] == {str(p): [2 * p] for p in range(n)}
