"""The port's remote naming schemes held against the JAX package's, on one
registry on localhost (``brpc_tpu_torch.tools.fake_registry``).

  * each of ``dns://``, ``http://``, ``https://``, ``consul://`` (the
    health API and a plain list, which may name ``ici://`` ranks),
    ``remotefile://``, ``nacos://`` and ``discovery://`` resolves, in
    both packages, to the same entries (endpoint, weight, tag), the
    golden payloads of ``tests/fixtures`` included;
  * the consul blocking watch of ``tests/test_naming_watch.py:146-215``:
    the poll carries the primed index, a bump publishes well under one
    polling period, and the next round carries the new index;
  * a consul answer with no index degrades to the polling cadence, and
    after an error the next round waits one period;
  * ``stop`` during a held poll returns within its timeout;
  * a Channel over ``remotefile://`` balances over the listed servers and
    follows a withdrawal.
"""
from __future__ import annotations

import os
import time

import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.policy import naming as jnaming
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.policy import naming as tnaming
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.tools.fake_registry import (CONSUL_PREFIX,
                                                FakeRegistry)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _fixture(name):
    import json
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def _entries(es):
    return [(str(e.endpoint), e.weight, e.tag) for e in es]


@pytest.fixture()
def reg():
    r = FakeRegistry()
    yield r
    r.close()


@pytest.fixture()
def poll_period():
    old = tflags.get_flag("ns_poll_interval_s")

    def set_period(s):
        tflags.set_flag("ns_poll_interval_s", s)
    yield set_period
    tflags.set_flag("ns_poll_interval_s", old)


def _both(url):
    """The entries each package's naming service resolves ``url`` to."""
    j = _entries(jnaming.create_naming_service(url).get_servers())
    t = _entries(tnaming.create_naming_service(url).get_servers())
    return j, t


# ---- one resolution, both packages -------------------------------------

@pytest.mark.parametrize("scheme", ["dns", "http", "https"])
def test_dns_resolves_like_jax(scheme):
    j, t = _both(f"{scheme}://localhost:8123")
    assert t == j
    assert ("127.0.0.1:8123", 100, "") in t


def test_consul_health_form_equals_jax(reg):
    reg.set_consul("web", _fixture("consul_health_service.json"))
    j, t = _both(f"consul://{reg.hostport}/web")
    assert t == j == [("10.1.10.12:8000", 100, "primary,v1"),
                      ("10.1.10.13:8001", 100, "")]
    ns = tnaming.create_naming_service(f"consul://{reg.hostport}/web")
    ns.get_servers()
    assert ns.last_index == "1"          # the header primed the index


def test_consul_plain_list_names_ici_ranks(reg):
    reg.set_consul("fab", ["ici://4", "ici://5", "10.0.0.9:80",
                           "mem://m-x"], indexed=False)
    j, t = _both(f"consul://{reg.hostport}/fab")
    assert t == j == [("ici://4", 100, ""), ("ici://5", 100, ""),
                      ("10.0.0.9:80", 100, ""), ("mem://m-x", 100, "")]
    ns = tnaming.create_naming_service(f"consul://{reg.hostport}/fab")
    ns.get_servers()
    assert ns.last_index is None


def test_remotefile_equals_jax(reg):
    reg.set_file("/servers.txt", ["# members", "10.2.0.1:80 tagA",
                                  "ici://3 200 1/4", "",
                                  "10.2.0.2:81 # trailing"])
    for url in (f"remotefile://{reg.hostport}/servers.txt",
                f"remotefile://http://{reg.hostport}/servers.txt"):
        j, t = _both(url)
        assert t == j == [("10.2.0.1:80", 100, "tagA"),
                          ("ici://3", 200, "1/4"), ("10.2.0.2:81", 100, "")]


def test_nacos_equals_jax(reg):
    doc = _fixture("nacos_instance_list.json")
    reg.set_nacos("demo.service", doc["hosts"])
    j, t = _both(f"nacos://{reg.hostport}/demo.service")
    # unhealthy (.7) and disabled (.8) dropped, weight x 100
    assert t == j == [("10.2.0.5:8848", 100, "DEFAULT"),
                      ("10.2.0.6:8848", 250, "DEFAULT")]
    reg.set_nacos("q", [{"ip": "10.0.0.1", "port": 8000, "weight": 2.0,
                         "clusterName": "c1"}])
    j, t = _both(f"nacos://{reg.hostport}/q?namespaceId=ns&groupName=g")
    assert t == j == [("10.0.0.1:8000", 200, "c1")]
    assert reg.queries[-1][2] == {"serviceName": "q", "namespaceId": "ns",
                                  "groupName": "g"}


def test_discovery_equals_jax(reg):
    doc = _fixture("discovery_fetchs.json")
    reg.set_discovery("demo.service",
                      doc["data"]["demo.service"]["instances"])
    j, t = _both(f"discovery://{reg.hostport}/demo.service")
    assert t == j == [("10.3.1.1:9000", 100, "sh001"),
                      ("10.3.1.1:8080", 100, "sh001"),
                      ("10.3.1.3:9000", 100, "sh003")]
    assert reg.queries[-1][2] == {"appid": "demo.service", "env": "prod",
                                  "status": "1"}


def test_unknown_scheme_refused_by_both():
    for ns in (jnaming, tnaming):
        with pytest.raises(ValueError, match="zk"):
            ns.create_naming_service("zk://x:1/s")


# ---- the consul watch ----------------------------------------------------

def _watcher():
    got = []

    class W:
        def reset_servers(self, entries):
            got.append((time.monotonic(), [str(e.endpoint)
                                           for e in entries]))
    return W(), got


def _wait(fn, t=5.0):
    end = time.monotonic() + t
    while not fn() and time.monotonic() < end:
        time.sleep(0.005)
    return fn()


def _held_with(reg, index):
    with reg.lock:
        return any(p.startswith(CONSUL_PREFIX) and q.get("index") == index
                   for _t, p, q in reg.queries)


def test_consul_watch_index_round_trip_well_under_a_period(reg,
                                                           poll_period):
    # a 30 s period: a change seen within a second came by the long poll
    poll_period(30.0)
    reg.set_consul("web", [reg.consul_item("10.9.0.1", 80)])
    t = tnaming.NamingServiceThread(f"consul://{reg.hostport}/web")
    try:
        w, got = _watcher()
        t.add_watcher(w)
        assert got and got[-1][1] == ["10.9.0.1:80"]
        assert _wait(lambda: _held_with(reg, "1")), reg.queries
        t0 = time.monotonic()
        reg.set_consul("web", [reg.consul_item("10.9.0.1", 80),
                               reg.consul_item("10.9.0.2", 81)])
        assert _wait(lambda: len(got[-1][1]) == 2)
        assert got[-1][1] == ["10.9.0.1:80", "10.9.0.2:81"]
        assert got[-1][0] - t0 < 1.0
        assert _wait(lambda: _held_with(reg, "2")), reg.queries
        # a withdrawal travels the same way
        t0 = time.monotonic()
        reg.set_consul("web", [reg.consul_item("10.9.0.2", 81)])
        assert _wait(lambda: got[-1][1] == ["10.9.0.2:81"])
        assert got[-1][0] - t0 < 1.0
    finally:
        t0 = time.monotonic()
        t.stop(2.0)
        assert time.monotonic() - t0 < 2.0


def test_consul_without_index_degrades_to_polling(reg, poll_period):
    """A consul answer with no index is polled once a period, not re-asked
    at once: the rounds keep coming, each at least half a period after the
    one before (a hot loop would be a millisecond apart)."""
    poll_period(0.2)
    path = CONSUL_PREFIX + "plain"
    reg.set_consul("plain", ["10.0.0.1:80"], indexed=False)
    t = tnaming.NamingServiceThread(f"consul://{reg.hostport}/plain")
    try:
        w, got = _watcher()
        t.add_watcher(w)
        t0 = time.monotonic()
        assert _wait(lambda: reg.count(path, since=t0) >= 4, 10.0)
        with reg.lock:
            ts = [q[0] for q in reg.queries if q[1] == path and q[0] >= t0]
            assert all("index" not in q[2] for q in reg.queries)
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        assert min(gaps) >= 0.1, gaps
        reg.set_consul("plain", ["10.0.0.1:80", "10.0.0.2:80"],
                       indexed=False)
        assert _wait(lambda: len(got[-1][1]) == 2, 5.0)
    finally:
        t.stop(2.0)


def test_consul_error_waits_one_period(reg, poll_period):
    poll_period(1.0)
    path = CONSUL_PREFIX + "web"
    reg.set_consul("web", [reg.consul_item("10.9.0.1", 80)])
    t = tnaming.NamingServiceThread(f"consul://{reg.hostport}/web")
    try:
        w, got = _watcher()
        t.add_watcher(w)
        assert _wait(lambda: _held_with(reg, "1"))
        reg.fail_next(1)                  # the next round's answer
        t0 = time.monotonic()
        reg.set_consul("web", [reg.consul_item("10.9.0.3", 80)])
        # the released poll gets 500; the round after it waits a period
        assert _wait(lambda: reg.count(path, since=t0) >= 2, 10.0)
        with reg.lock:
            ts = [q[0] for q in reg.queries if q[1] == path and q[0] >= t0]
        # a hot retry would be a millisecond apart
        assert ts[1] - ts[0] >= 0.7, ts
        assert _wait(lambda: got[-1][1] == ["10.9.0.3:80"], 10.0)
    finally:
        t.stop(2.0)


def test_stop_during_a_held_poll_returns_within_its_timeout(reg,
                                                            poll_period):
    poll_period(30.0)
    reg.set_consul("web", [reg.consul_item("10.9.0.1", 80)])
    t = tnaming.NamingServiceThread(f"consul://{reg.hostport}/web")
    assert _wait(lambda: _held_with(reg, "1"))
    time.sleep(0.1)                       # inside the held read
    t0 = time.monotonic()
    t.stop(2.0)
    dt = time.monotonic() - t0
    assert dt < 1.0, dt
    assert not t._thread.is_alive()
    # a stopped source fetches nothing more
    n = reg.count(CONSUL_PREFIX + "web")
    reg.set_consul("web", [])
    time.sleep(0.2)
    assert reg.count(CONSUL_PREFIX + "web") == n


# ---- a Channel over a remote list -------------------------------------

class _Tagged(rpc.Service):
    SERVICE_NAME = "Tagged"

    def __init__(self, tag):
        self.tag = tag

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = self.tag
        done()


def test_channel_over_remotefile_balances_and_follows_a_withdrawal(
        reg, poll_period):
    poll_period(0.1)
    names = [f"nrem-{os.getpid()}-{i}" for i in range(3)]
    servers = []
    for n in names:
        s = rpc.Server()
        s.add_service(_Tagged(n))
        assert s.start(f"mem://{n}") == 0
        servers.append(s)
    reg.set_file("/fleet", [f"mem://{n}" for n in names])
    url = f"remotefile://{reg.hostport}/fleet"
    ch = rpc.Channel()
    try:
        assert ch.init(url, "rr") == 0

        def call():
            cntl = rpc.Controller()
            r = ch.call_method("Tagged.Echo", cntl, EchoRequest(message="x"),
                               EchoResponse)
            assert not cntl.failed(), cntl.error_text
            return r.message
        seen = [call() for _ in range(30)]
        assert {n: seen.count(n) for n in names} == {n: 10 for n in names}
        reg.set_file("/fleet", [f"mem://{n}" for n in names[:2]])
        assert _wait(lambda: all(call() != names[2] for _ in range(6)))
        assert names[2] not in {call() for _ in range(12)}
    finally:
        ch.close()
        tnaming.stop_naming_service_thread(url)
        for s in servers:
            s.stop()


# ---- chip_smoke.py phase 22, rehearsed on the CPU ----------------------

_PHASE22_CPU = r"""
import importlib, json, os, sys
sys.path.insert(0, %(repo)r)
import chip_smoke as cs
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
cm = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
plain = [0]
inner = cm.p2p_copy_plain
def counted(src, dst):
    plain[0] += 1
    return inner(src, dst)
cm.p2p_copy_plain = counted
flags.set_flag("ici_device_plane_host_mesh", True)
mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
cs.NAMING_CALLS, cs.NAMING_TCP_CALLS, cs.NAMING_ECHOES = 40, 16, 4
out = cs.phase_remote_naming(mesh, device_plane.plane(), cm.p2p_copy,
                             launches=lambda: plain[0])
out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                        or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
print("RESULT " + json.dumps(out), flush=True)
"""


def test_phase22_remote_naming_rehearsal_on_cpu():
    """Phase 22 (a)-(c) on a CPU mesh at a small size, its own checks
    held: launches = transfers = calls received over ici://4-7 on
    ``remotefile://``, ici://7 dropped after its withdrawal, the consul
    watch under a period, nacos/discovery/dns resolved, 0 failed calls."""
    import json
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c",
                           _PHASE22_CPU % {"repo": repo}], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    r = json.loads(lines[-1][len("RESULT "):])
    assert r["foreign"] == []
    a = r["a"]
    assert a["launches"] == a["transfers"] == a["received"] == a["calls"]
    assert a["per_member"] == {f"ici://{k}": 10 for k in range(4, 8)}
    assert r["b"]["launches"] == 0 and len(r["b"]["watch_ms"]) == 2
    assert r["c"]["launches"] == 0


def test_phase22_plane_trace_rehearsal_on_cpu():
    """Phase 22 (d)-(e) on the CPU: a member process and its peer, the
    trace's order in both, and a payload under the native window and one
    over it, each forwarded off a recycled ring slot."""
    import chip_smoke as cs
    r = cs.phase_plane_trace(device="cpu", RELOC_NATIVE=1 << 20,
                             RELOC_PAYLOAD=5 << 20, RELOC_RING=12 << 20)
    assert r["foreign"] == [] and r["launches"] == 0
    for door in ("native", "python"):
        e = r["e"][door]
        assert e["recycled"] and e["kept"]["sha256"] == e["first_sha256"]
    assert r["e"]["native"]["seen"][0]["relocated"]["device_put"] == 1
