"""Pod-scope observability on both packages: the Trace service's process
id, the per-peer clock table, the span stitcher and the pod-scope pages
(``brpc_tpu.ici.clock`` / ``brpc_tpu.rpc.builtin.pod_scope`` and the
port's counterparts).

  * ``local_pid()``: with a ``FabricNode`` stand-in whose ``process_id``
    is 2 in both packages, ``brpc_tpu.Trace.FindTrace``/``ListRecent`` and
    ``brpc_tpu.Builtin.Call`` answer ``"pid": 2`` in both (the port
    answered -1 in any fabric process before);
  * ``clock``: the same samples, with ``time.monotonic`` patched alike,
    give the same offsets, bounds, alignments and tables, the stale and
    drift cases included;
  * ``stitch_tree`` on one span list; ``rpcz_pod`` with its members and
    the local span store stubbed alike; ``vars_pod`` and ``metrics_pod``
    with the member fetch stubbed; the fan-out's error entries; the pages'
    answers with no pod.

Tolerance: exact equality (bytes, ids, integers, and floats computed by
the same formulas).
"""
from __future__ import annotations

import json
import types

import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.ici import clock as jclock
from brpc_tpu.ici import fabric as jfab
from brpc_tpu.ici import pod as jpod
from brpc_tpu.rpc import span as jspan
from brpc_tpu.rpc.builtin import pod_scope as jscope
from brpc_tpu.rpc.builtin import rpc_service as jrs
from brpc_tpu.rpc.builtin import services as jservices
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch.ici import clock as tclock
from brpc_tpu_torch.ici import fabric as tfab
from brpc_tpu_torch.ici import pod as tpod
from brpc_tpu_torch.rpc import span as tspan
from brpc_tpu_torch.rpc.builtin import pod_scope as tscope
from brpc_tpu_torch.rpc.builtin import rpc_service as trs
from brpc_tpu_torch.rpc.builtin import services as tservices

JAX = types.SimpleNamespace(clock=jclock, fab=jfab, pod=jpod, span=jspan,
                            scope=jscope, rs=jrs, services=jservices)
PORT = types.SimpleNamespace(clock=tclock, fab=tfab, pod=tpod, span=tspan,
                             scope=tscope, rs=trs, services=tservices)
BOTH = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def drained():
    """The clock tables and the fan-out channel caches are left empty, and
    the port's sockets closed, after the module."""
    yield
    for p in BOTH:
        p.clock.reset_for_test()
        p.scope.close_channels_for_test()
    from brpc_tpu_torch import rpc
    assert not rpc.list_sockets()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both clock modules read one settable monotonic clock."""
    now = [1000.0]
    fake = types.SimpleNamespace(monotonic=lambda: now[0])
    for p in BOTH:
        monkeypatch.setattr(p.clock, "time", fake)
        p.clock.reset_for_test()
    yield now
    for p in BOTH:
        p.clock.reset_for_test()


# ---- local_pid -------------------------------------------------------------

class _Cntl:
    def __init__(self, server=None):
        self.server = server
        self.failed_with = None

    def set_failed(self, code, text=""):
        self.failed_with = (code, text)


def _answers(p):
    """The pid each of the package's three admin methods answers."""
    out = {}
    for method, req in (("FindTrace", {"trace_id": "1f"}),
                        ("ListRecent", {"limit": 1})):
        resp = p.rs.JsonMsg()
        cntl = _Cntl()
        getattr(p.rs.TraceService(), method)(
            cntl, p.rs.JsonMsg(**req), resp, lambda: None)
        assert cntl.failed_with is None
        out[method] = resp.fields["pid"]
    server = types.SimpleNamespace(
        options=types.SimpleNamespace(internal_port=-1),
        _builtin=types.SimpleNamespace(
            dispatch=lambda page, q: ("text/plain", "x")))
    resp = p.rs.JsonMsg()
    cntl = _Cntl(server)
    p.rs.BuiltinRpcService().Call(cntl, p.rs.JsonMsg(page="version"), resp,
                                  lambda: None)
    assert cntl.failed_with is None
    out["Builtin.Call"] = resp.fields["pid"]
    return out


def test_trace_service_answers_the_fabric_process_id(monkeypatch):
    """A fabric process's admin services answer its process id in both
    packages; with no fabric node both answer -1."""
    for p in BOTH:
        monkeypatch.setattr(p.fab.FabricNode, "_instance", None)
    assert _answers(JAX) == _answers(PORT) == dict.fromkeys(
        ("FindTrace", "ListRecent", "Builtin.Call"), -1)
    for p in BOTH:
        monkeypatch.setattr(p.fab.FabricNode, "_instance",
                            types.SimpleNamespace(process_id=2))
    assert JAX.rs.local_pid() == PORT.rs.local_pid() == 2
    assert _answers(JAX) == _answers(PORT) == dict.fromkeys(
        ("FindTrace", "ListRecent", "Builtin.Call"), 2)


# ---- clock -----------------------------------------------------------------

_SAMPLES = [
    # (advance s, pid, offset_us, bound_us)
    (0.0, 1, 120.0, 40.0),
    (1.0, 1, 300.0, 90.0),       # looser: the first (drift-aged) stays
    (2.0, 1, -15.0, 10.0),       # tighter: replaces it
    (0.0, 2, 7.5, 3.0),
    (5000.0, 2, 9.0, 120.0),     # drift aged past 120 µs: replaced
    (0.5, 3, 1.0, 1e6),
    (700.0, 1, 50.0, 500.0),     # the kept sample is stale: replaced
]


def _clock_trace(p, now):
    out = []
    for advance, pid, off, bound in _SAMPLES:
        now[0] += advance
        p.clock.record(pid, off, bound)
        out.append((p.clock.offset(pid), p.clock.to_local_wall_us(pid, 1e9),
                    p.clock.to_local_wall_us(9, 1e9), p.clock.describe()))
    now[0] += 30.0
    out.append([p.clock.offset(q) for q in (1, 2, 3, 4)])
    return out


def test_clock_samples_equal_jax(fixed_clock):
    """Tightest-bound rule, ``_STALE_S``, the 20 ppm drift allowance,
    alignment and the table: equal after every sample."""
    jax_trace = _clock_trace(JAX, fixed_clock)
    fixed_clock[0] = 1000.0
    port_trace = _clock_trace(PORT, fixed_clock)
    assert jax_trace == port_trace
    assert JAX.clock._STALE_S == PORT.clock._STALE_S
    assert JAX.clock._DRIFT_US_PER_S == PORT.clock._DRIFT_US_PER_S


def test_hello_ok_echo_records_the_offset(fixed_clock):
    """The client's handshake records ``wall_us - (t0 + rtt/2)`` with bound
    ``rtt/2 + 1`` from the HELLO_OK echo; a malformed echo records
    nothing."""
    import time
    tfab.FabricNode._record_clock(
        3, json.dumps({"t0": 1_000, "wall_us": 2_500}).encode(),
        time.monotonic_ns() - 800_000)         # at least 800 µs ago
    off, bound = tclock.offset(3)
    assert bound >= 401.0
    assert off + (bound - 1.0) == 2_500 - 1_000
    tfab.FabricNode._record_clock(4, b"not json", 0)
    tfab.FabricNode._record_clock(4, b"", 0)
    assert tclock.offset(4) is None


# ---- stitching -------------------------------------------------------------

def _span(sid, parent, start, process, side="server", bound=0.0):
    return {"trace_id": "00000000000000aa", "span_id": sid,
            "parent": parent, "side": side, "method": f"M.{sid}",
            "start_real_us": start, "latency_us": 10, "error_code": 0,
            "remote": "ici://0", "annotations": [[0, "x"]],
            "process": process, "aligned_start_us": start,
            "clock_bound_us": bound}


_SPANS = [
    _span("r", "0000000000000000", 100, 0, "client"),
    _span("b", "r", 130, 1, bound=12.5),
    _span("a", "r", 120, 0),
    _span("c", "b", 125, 2, "transfer", 7.0),
    _span("d", "b", 140, 2),
    _span("self", "self", 90, 1),            # its own parent: a root
    _span("orphan", "missing", 95, 2),
]


def test_stitch_tree_equals_jax():
    j = jscope.stitch_tree([dict(s) for s in _SPANS])
    t = tscope.stitch_tree([dict(s) for s in _SPANS])
    assert j == t
    assert [n["span_id"] for n in t] == ["self", "orphan", "r"]
    assert [n["span_id"] for n in t[2]["children"]] == ["a", "b"]


class _SpanObj:
    def __init__(self, d):
        self.d = d

    def describe(self):
        return dict(self.d)


def test_rpcz_pod_equals_jax(fixed_clock, monkeypatch):
    """One trace query over a stubbed pod of four members (the local one,
    two reachable, one unreachable, one with no serving rank) gives the
    same stitched answer in both packages, remote spans aligned by the
    clock table."""
    local = [_span("r", "0000000000000000", 1_000_000, 0, "client")]
    remote = {"ici://2": [_span("b", "r", 1_000_400, 1)],
              "ici://4": None}
    for p in BOTH:
        for k in ("process", "aligned_start_us", "clock_bound_us"):
            for s in local + remote["ici://2"]:
                s.pop(k, None)
        pod_stub = types.SimpleNamespace(pid=0, name="pd")
        monkeypatch.setattr(p.scope, "_member_targets", lambda ps=pod_stub: (
            ps, [(0, None), (1, "ici://2"), (2, "ici://4"), (3, None)]))

        def call(target, method, fields):
            if remote[target] is None:
                raise ConnectionError(f"{method} at {target}: 1009 down")
            return {"spans": [dict(s) for s in remote[target]]}

        monkeypatch.setattr(p.scope, "_call_member", call)
        monkeypatch.setattr(p.span, "find_trace",
                            lambda tid: [_SpanObj(s) for s in local])
        p.clock.record(1, 250.0, 30.0)
    bodies = [json.loads(p.scope.rpcz_pod(None, {"trace_id": "aa"})[1])
              for p in BOTH]
    assert bodies[0] == bodies[1]
    tree = bodies[1]["tree"]
    assert len(tree) == 1 and tree[0]["children"][0]["span_id"] == "b"
    assert tree[0]["children"][0]["aligned_start_us"] == 1_000_150
    assert tree[0]["children"][0]["clock_bound_us"] == 30.0
    assert bodies[1]["processes"]["2"]["error"].startswith("ConnectionError")
    assert bodies[1]["processes"]["3"] == {"error": "no serving endpoint"}


_PAGES = {
    0: {"body": "# TYPE a gauge\na 1\n# TYPE b gauge\nb 2.5\n"},
    1: {"error": "ConnectionError: unreachable"},
    2: {"body": "# TYPE a gauge\na 3\n\nweird\n"},
}


def test_vars_and_metrics_pod_equal_jax(monkeypatch):
    """The process-grouped /vars and the process-labelled Prometheus
    exposition, the member fetch stubbed alike."""
    for p in BOTH:
        monkeypatch.setattr(p.scope, "_fanout_page",
                            lambda server, page, q: {
                                k: dict(v) for k, v in _PAGES.items()})
    for fn in ("metrics_pod", "vars_pod"):
        j = getattr(jscope, fn)(None, {"filter": "a*"})
        t = getattr(tscope, fn)(None, {"filter": "a*"})
        assert j == t, fn
    body = tscope.metrics_pod(None, {})[1]
    assert 'a{process="0"} 1' in body and 'a{process="2"} 3' in body
    assert body.count("# TYPE a gauge") == 1
    assert body.startswith("# process 1 unreachable")


def test_fanout_error_entries_equal_jax():
    def boom():
        raise ValueError("no route")

    for p in BOTH:
        assert p.scope._fanout_members({1: lambda: 5, 2: boom}) == {
            1: ("ok", 5), 2: ("err", "ValueError: no route")}


@pytest.mark.parametrize("page,query", [
    ("_vars", {"scope": "pod"}), ("_metrics", {"scope": "pod"}),
    ("_rpcz", {"scope": "pod"}), ("_rpcz", {"scope": "pod",
                                            "trace_id": "ab"})])
def test_pages_without_a_pod_equal_jax(page, query, monkeypatch):
    """A pod-scope query in a process that joined no pod answers the same
    refusal in both packages."""
    for p in BOTH:
        monkeypatch.setattr(p.pod.Pod, "_instance", None)
    j = getattr(jservices, page)(None, dict(query))
    t = getattr(tservices, page)(None, dict(query))
    assert j == t


def test_ici_page_carries_the_pod_block(monkeypatch):
    pod = types.SimpleNamespace(describe=lambda: {"name": "pd", "epoch": 9})
    monkeypatch.setattr(tpod.Pod, "_instance", pod)
    out = json.loads(tservices._ici(None, {})[1])
    assert out["pod"] == {"name": "pd", "epoch": 9}
    monkeypatch.setattr(tpod.Pod, "_instance", None)
    assert "pod" not in json.loads(tservices._ici(None, {})[1])


# ---- one trace across two processes ------------------------------------

_TRACE_2PROC = r"""
from brpc_tpu_torch.ici import clock
from brpc_tpu_torch.ici.pod import Pod
flags.set_flag("rpcz_enabled", True)
MYDEV = 2 * pid
pod = Pod.join("trace2")

class Svc(rpc.Service):
    SERVICE_NAME = "EchoService"
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        time.sleep(0.02)                  # a visible server-side dwell
        response.message = "p%d" % pid
        done()

server = rpc.Server(rpc.ServerOptions(native_ici=False))
server.add_service(Svc())
assert server.start("ici://%d" % MYDEV) == 0
pod.wait_epoch(2 * NPROC, timeout=60)
out = {"foreign": foreign()}
if pid == 0:
    ch = rpc.Channel()
    ch.init("ici://2", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    cntl = rpc.Controller()
    ch.call_method("EchoService.Echo", cntl, EchoRequest(message="x"),
                   EchoResponse)
    out["failed"] = cntl.failed()
    tid = cntl.trace_id
    out["tid"] = tid
    out["offset"] = clock.offset(1)
    end = time.time() + 30
    while time.time() < end:
        _ctype, body = server._builtin.dispatch("rpcz",
                                                {"trace_id": "%x" % tid})
        res = json.loads(body)
        if res.get("span_count", 0) >= 2:
            break
        time.sleep(0.1)
    out["rpcz"] = res
    ch.close()
    put("done", 1)
else:
    get("done")
barrier("exit")
server.stop()
pod.leave()
result(out)
finish()
"""


def test_cross_process_trace_continuity_and_clock_bound():
    """``tests/test_observability.py:468`` on the port: the client span
    (process 0) and the server span (process 1) share the trace, and one
    ``/rpcz?trace_id=`` on process 0 returns the stitched tree ordering
    A-send < B-recv < B-send < A-recv under the fabric's ±RTT/2 clock
    bound."""
    from tests.torch_procs import ok, run_procs
    p0, p1 = ok(run_procs(_TRACE_2PROC, 2, timeout=120))
    assert p0["failed"] is False and p0["tid"]
    assert p0["offset"] is not None
    assert 0 < p0["offset"][1] < 5_000_000, p0["offset"]
    out = p0["rpcz"]
    assert out["scope"] == "pod", out
    tree = out["tree"]
    assert len(tree) == 1, json.dumps(tree)[:2000]
    root = tree[0]
    assert root["side"] == "client" and root["process"] == 0
    assert len(root["children"]) == 1, root["children"]
    srv = root["children"][0]
    assert srv["side"] == "server" and srv["process"] == 1
    assert srv["method"] == "EchoService.Echo"
    bound = srv["clock_bound_us"]
    assert bound >= 0, "the stitcher lost the clock bound"
    a_send = root["aligned_start_us"]
    a_recv = a_send + root["latency_us"]
    b_recv = srv["aligned_start_us"]
    b_send = b_recv + srv["latency_us"]
    assert b_recv >= a_send - bound, (a_send, b_recv, bound)
    assert b_send <= a_recv + bound, (b_send, a_recv, bound)
    assert b_recv < b_send
    assert p0["foreign"] == p1["foreign"] == []
