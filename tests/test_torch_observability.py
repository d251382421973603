"""rpcz spans, the tpu_std stage recorders and the builtin pages as RPC
methods, held against the JAX package on the CPU.

Mirrors ``tests/test_auth_rpcz.py``'s TestRpcz and the in-process legs of
``tests/test_observability.py``:

  * spans recorded and propagated across a two-hop call (mem:// then a CPU
    ici:// mesh): the same tree of client and server spans in both;
  * rpcz off records nothing;
  * the ``sampled`` and ``on`` stage modes (and ``off``);
  * a device-plane transfer's annotations land in the client span's
    trace, on a transfer span parented under it;
  * an inline completion leaks no client span-local;
  * ``brpc_tpu.Builtin.Call`` and ``brpc_tpu.Trace.FindTrace``/
    ``ListRecent`` over RPC, the pages' keys compared with the JAX
    package's for the same scenario;
  * no admin services with ``enable_builtin_services=False``.
"""
from __future__ import annotations

import json
import threading
import time
import types

import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.bthread import scheduler as jsched
from brpc_tpu.butil import flags as jflags
from brpc_tpu.policy import tpu_std as jtpu_std
from brpc_tpu.rpc import span as jspan
from brpc_tpu.rpc.builtin.rpc_service import JsonMsg as JJsonMsg
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.bthread import scheduler as tsched
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici import transport as ici_transport
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import tpu_std as ttpu_std
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import span as tspan
from brpc_tpu_torch.rpc.builtin.rpc_service import JsonMsg
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import EchoRequest as JEchoRequest
from tests.echo_pb2 import EchoResponse as JEchoResponse

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, flags=jflags, span=jspan,
                            tpu_std=jtpu_std, sched=jsched, Json=JJsonMsg,
                            Req=JEchoRequest, Resp=JEchoResponse)
PORT = types.SimpleNamespace(name="torch", rpc=rpc, flags=tflags,
                             span=tspan, tpu_std=ttpu_std, sched=tsched,
                             Json=JsonMsg, Req=EchoRequest,
                             Resp=EchoResponse)
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])
_FLAGS = ("rpcz_enabled", "tpu_std_stage_metrics", "ici_device_plane",
          "ici_device_plane_host_mesh", "ici_device_plane_threshold")
_names = iter(range(100_000))


@pytest.fixture(scope="module", autouse=True)
def cpu_mesh():
    """The port on a CPU mesh with the plane engaged; every flag this file
    moves restored after it; the port's sockets and server Controllers
    returned."""
    saved = {(p.name, n): p.flags.get_flag(n)
             for p in (JAX, PORT) for n in _FLAGS[:2]}
    tsaved = {n: tflags.get_flag(n) for n in _FLAGS[2:]}
    IciMesh.set_default(IciMesh(ranks=8, device="cpu"))
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    yield
    for (name, n), v in saved.items():
        (JAX if name == "jax" else PORT).flags.set_flag(n, v)
    for n, v in tsaved.items():
        tflags.set_flag(n, v)
    IciMesh.set_default(None)
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


@pytest.fixture
def rpcz_on():
    olds = [(p, p.flags.get_flag("rpcz_enabled")) for p in (JAX, PORT)]
    for p, _ in olds:
        p.flags.set_flag("rpcz_enabled", True)
        # a fresh second for the sampling budget
        p.span._speed_limit._window_start = 0.0
    yield
    for p, v in olds:
        p.flags.set_flag("rpcz_enabled", v)


def _echo_service(pkg):
    class Echo(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

    return Echo()


def _server(pkg, addr, svc=None, **opts):
    o = pkg.rpc.ServerOptions()
    for k, v in opts.items():
        setattr(o, k, v)
    if addr.startswith("ici://"):
        # both packages on the Python ici plane: it carries the server
        # spans and the stage annotations these tests read
        o.native_ici = False
    s = pkg.rpc.Server(o)
    s.add_service(svc or _echo_service(pkg))
    assert s.start(addr) == 0
    return s


def _channel(pkg, addr, **opts):
    ch = pkg.rpc.Channel()
    ch.init(addr, options=pkg.rpc.ChannelOptions(timeout_ms=10000, **opts))
    return ch


def _echo(pkg, ch, msg="t", method="EchoService.Echo"):
    cntl = pkg.rpc.Controller()
    resp = ch.call_method(method, cntl, pkg.Req(message=msg), pkg.Resp)
    assert not cntl.failed(), cntl.error_text
    return cntl, resp


def _wait_trace(pkg, trace_id, n, kinds=None):
    deadline = time.monotonic() + 5
    spans = []
    while time.monotonic() < deadline:
        spans = [s for s in pkg.span.find_trace(trace_id)
                 if s.end_us and (kinds is None or s.kind in kinds)]
        if len(spans) >= n:
            break
        time.sleep(0.01)
    return spans


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------

def _two_hop(pkg):
    """client → Front on mem:// → (inside its handler) Echo on ici://2:
    the trace's spans as (kind, method, index of the parent span)."""
    tag = next(_names)
    back = _server(pkg, "ici://2")
    inner = _channel(pkg, "ici://2")

    class Front(pkg.rpc.Service):
        SERVICE_NAME = "Front"

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Relay(self, cntl, request, response, done):
            _, r = _echo(pkg, inner, request.message + "!")
            response.message = r.message
            done()

    front = _server(pkg, f"mem://obs_front_{tag}", Front())
    ch = _channel(pkg, f"mem://obs_front_{tag}")
    try:
        cntl, resp = _echo(pkg, ch, "hop", method="Front.Relay")
        assert resp.message == "hop!"
        spans = _wait_trace(pkg, cntl.trace_id, 4)
    finally:
        ch.close()
        inner.close()
        front.stop()
        back.stop()
    assert len(spans) == 4, [s.describe() for s in spans]
    by_id = {s.span_id: s for s in spans}
    order = sorted(spans, key=lambda s: s.start_us)
    index = {s.span_id: i for i, s in enumerate(order)}
    return [(s.kind, s.method, index.get(s.parent_span_id, -1)
             if s.parent_span_id in by_id else -1) for s in order]


def test_spans_propagate_across_two_hops_alike(rpcz_on):
    j = _two_hop(JAX)
    t = _two_hop(PORT)
    assert t == j == [("client", "Front.Relay", -1),
                      ("server", "Front.Relay", 0),
                      ("client", "EchoService.Echo", 1),
                      ("server", "EchoService.Echo", 2)]


@BOTH
def test_spans_recorded_and_propagated(pkg, rpcz_on):
    addr = f"mem://obs_rec_{next(_names)}"
    server = _server(pkg, addr)
    ch = _channel(pkg, addr)
    try:
        for _ in range(3):
            _echo(pkg, ch)
        time.sleep(0.05)
        spans = pkg.span.recent_spans(100)
        client = [s for s in spans if s.is_client
                  and s.method == "EchoService.Echo"]
        srv = [s for s in spans if not s.is_client
               and s.method == "EchoService.Echo"]
        assert client and srv
        assert any(s.trace_id in {c.trace_id for c in client} for s in srv)
        d = client[-1].describe()
        assert d["latency_us"] > 0 and d["side"] == "client"
        assert any(a.startswith("issue try=0") for _, a in
                   client[-1].annotations)
    finally:
        ch.close()
        server.stop()


@BOTH
def test_rpcz_off_records_nothing(pkg):
    old = pkg.flags.get_flag("rpcz_enabled")
    pkg.flags.set_flag("rpcz_enabled", False)
    addr = f"mem://obs_off_{next(_names)}"
    before = len(pkg.span.recent_spans(10000))
    server = _server(pkg, addr)
    ch = _channel(pkg, addr)
    try:
        cntl, _ = _echo(pkg, ch, "q")
        assert cntl.trace_id == 0 and cntl.span is None
    finally:
        ch.close()
        server.stop()
        pkg.flags.set_flag("rpcz_enabled", old)
    assert len(pkg.span.recent_spans(10000)) == before


def test_transfer_annotations_land_in_the_client_trace(rpcz_on):
    """A request attachment that crosses the device plane: its posted →
    matched → complete timeline is a transfer span parented under the
    client span, in both packages."""
    import jax
    import jax.numpy as jnp
    from brpc_tpu.ici.mesh import IciMesh as JMesh
    olds = {n: jflags.get_flag(n) for n in ("ici_device_plane_host_mesh",
                                           "ici_device_plane_threshold")}
    jflags.set_flag("ici_device_plane_host_mesh", True)
    jflags.set_flag("ici_device_plane_threshold", 4096)
    tflags.set_flag("ici_device_plane_threshold", 4096)
    out = {}
    try:
        for pkg in (JAX, PORT):
            server = _server(pkg, "ici://0")
            ch = _channel(pkg, "ici://0", max_retry=0)
            try:
                cntl = pkg.rpc.Controller()
                if pkg is JAX:
                    payload = jax.device_put(
                        jnp.arange(65536, dtype=jnp.uint8),
                        JMesh.default().device(1))
                    jax.block_until_ready(payload)
                else:
                    payload = IciMesh.default().device_put(
                        torch.arange(65536).to(torch.uint8), 1)
                cntl.request_attachment.append_device_array(payload)
                ch.call_method("EchoService.Echo", cntl,
                               pkg.Req(message="x"), pkg.Resp)
                assert not cntl.failed(), cntl.error_text
                xfer = _wait_trace(pkg, cntl.trace_id, 1, ("transfer",))
                client = [s for s in pkg.span.find_trace(cntl.trace_id)
                          if s.kind == "client"]
                assert xfer and client
                assert all(x.parent_span_id == client[0].span_id
                           for x in xfer)
                ann = " | ".join(a for x in xfer for _, a in x.annotations)
                out[pkg.name] = [w for w in ("posted", "matched",
                                             "complete", "pin_held_us=")
                                 if w in ann]
            finally:
                ch.close()
                server.stop()
    finally:
        for n, v in olds.items():
            jflags.set_flag(n, v)
    assert out["torch"] == out["jax"] == ["posted", "matched", "complete",
                                          "pin_held_us="]


@BOTH
def test_inline_completion_leaks_no_client_span_local(pkg, rpcz_on):
    """usercode_inline completes the RPC inside the channel's write, which
    clears cntl.span: the restore keys on whether the span was published,
    so no finished span stays in the thread-local."""
    addr = f"mem://obs_leak_{next(_names)}"
    server = _server(pkg, addr, usercode_inline=True)
    ch = _channel(pkg, addr)
    try:
        cntl, _ = _echo(pkg, ch, "i")
        assert cntl.span is None
        assert pkg.sched.local_get("rpcz_client_span") is None
    finally:
        ch.close()
        server.stop()


# ---------------------------------------------------------------------------
# The tpu_std stages.
# ---------------------------------------------------------------------------

@BOTH
def test_sampled_request_gets_stage_annotations(pkg, rpcz_on):
    addr = f"mem://obs_stage_{next(_names)}"
    server = _server(pkg, addr)
    ch = _channel(pkg, addr)
    try:
        cntl, _ = _echo(pkg, ch, "d")
        srv = _wait_trace(pkg, cntl.trace_id, 1, ("server",))
        assert srv, "server span missing"
        ann = " | ".join(a for _, a in srv[0].annotations)
        for stage in ("queue", "parse", "handler", "encode", "write"):
            assert f"{stage}_us=" in ann, (stage, ann)
    finally:
        ch.close()
        server.stop()


@BOTH
@pytest.mark.parametrize("mode", ["on", "off"])
def test_stage_modes_feed_the_recorders(pkg, mode):
    """'on' feeds the five tpu_std_server_* recorders on every request,
    span or no span; 'off' feeds none."""
    recs = pkg.tpu_std._stage_recorders
    old = pkg.flags.get_flag("tpu_std_stage_metrics")
    pkg.flags.set_flag("tpu_std_stage_metrics", mode)
    before = {s: r.count() for s, r in recs.items()}
    addr = f"mem://obs_mode_{next(_names)}"
    server = _server(pkg, addr)
    ch = _channel(pkg, addr)
    try:
        _echo(pkg, ch, "d")
        grew = {s: recs[s].count() > n for s, n in before.items()}
    finally:
        pkg.flags.set_flag("tpu_std_stage_metrics", old)
        ch.close()
        server.stop()
    assert set(grew) == {"queue", "parse", "handler", "encode", "write"}
    assert all(grew.values()) if mode == "on" else not any(grew.values())
    if mode == "on":
        p50s = pkg.tpu_std.stage_p50s_us()
        assert set(p50s) == set(grew)


# ---------------------------------------------------------------------------
# The builtin pages over RPC.
# ---------------------------------------------------------------------------

_PAGES = ("health", "status", "vars", "flags", "connections", "rpcz",
          "brpc_metrics", "protobufs", "sockets", "bthreads", "ids",
          "index", "version", "threads", "list_services", "ici", "vlog",
          "dir")


def _builtin(pkg, ch, page, **query):
    c = pkg.rpc.Controller()
    r = ch.call_method("brpc_tpu.Builtin.Call", c,
                       pkg.Json(page=page, query=query), pkg.Json)
    assert not c.failed(), c.error_text
    return r.fields


def _pages(pkg):
    """One scenario: an echo server on ici://3, one traced call, then the
    Trace service and every page over Builtin.Call."""
    server = _server(pkg, "ici://3")
    ch = _channel(pkg, "ici://3")
    try:
        cntl, _ = _echo(pkg, ch, "t")
        got = {}
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            c2 = pkg.rpc.Controller()
            r2 = ch.call_method("brpc_tpu.Trace.FindTrace", c2,
                                pkg.Json(trace_id=f"{cntl.trace_id:x}"),
                                pkg.Json)
            assert not c2.failed(), c2.error_text
            got = r2.fields
            if len(got.get("spans", [])) >= 2:
                break
            time.sleep(0.02)
        c3 = pkg.rpc.Controller()
        r3 = ch.call_method("brpc_tpu.Trace.ListRecent", c3,
                            pkg.Json(limit=10), pkg.Json)
        assert not c3.failed()
        pages = {p: _builtin(pkg, ch, p) for p in _PAGES
                 if p in server._builtin.paths()}
        missing = _builtin(pkg, ch, "nope")
    finally:
        ch.close()
        server.stop()
    return got, r3.fields, pages, missing


def _json_keys(page):
    return set(json.loads(page["body"]))


def test_builtin_services_over_rpc_alike(rpcz_on):
    jgot, jrecent, jpages, jmissing = _pages(JAX)
    tgot, trecent, tpages, tmissing = _pages(PORT)
    # the Trace service: the call's client and server spans, same keys
    assert {s["side"] for s in tgot["spans"]} >= {"client", "server"}
    assert {"pid", "wall_us", "spans"} <= set(tgot) and \
        {"pid", "wall_us", "spans"} <= set(jgot)
    assert set(tgot["spans"][0]) == set(jgot["spans"][0])
    assert trecent["spans"] and jrecent["spans"]
    assert tmissing["status"] == jmissing["status"] == 404
    # every page the port carries answers 200 with the JAX page's shape
    assert set(tpages) == set(_PAGES)
    for page, body in tpages.items():
        assert body["status"] == 200, (page, body)
        assert set(body) == set(jpages[page]), page
    assert tpages["health"]["body"] == jpages["health"]["body"] == "OK"
    for page in ("status", "rpcz", "list_services", "protobufs"):
        assert _json_keys(tpages[page]) == _json_keys(jpages[page]), page
    assert _json_keys(tpages["ici"]) <= _json_keys(jpages["ici"])
    assert {"transport", "device_plane", "device_plane_recent"} <= \
        _json_keys(tpages["ici"])
    assert set(json.loads(tpages["index"]["body"])["paths"]) <= \
        set(json.loads(jpages["index"]["body"])["paths"])
    tvars = dict(line.split(" : ", 1) for line in
                 tpages["vars"]["body"].splitlines() if " : " in line)
    assert "process_pid" in tvars and "tpu_std_server_handler_count" in tvars
    assert "rpcz_enabled=True" in tpages["flags"]["body"]


@BOTH
def test_builtin_absent_when_builtin_services_disabled(pkg):
    """``enable_builtin_services=False`` mounts neither admin service:
    both calls fail ENOSERVICE while the server's own service answers."""
    addr = f"mem://obs_nobuiltin_{next(_names)}"
    server = _server(pkg, addr, enable_builtin_services=False)
    ch = _channel(pkg, addr, max_retry=0)
    try:
        c = pkg.rpc.Controller()
        ch.call_method("brpc_tpu.Builtin.Call", c, pkg.Json(page="flags"),
                       pkg.Json)
        assert c.failed() and c.error_code == errors.ENOSERVICE
        c2 = pkg.rpc.Controller()
        ch.call_method("brpc_tpu.Trace.ListRecent", c2, pkg.Json(limit=5),
                       pkg.Json)
        assert c2.failed() and c2.error_code == errors.ENOSERVICE
        _echo(pkg, ch)
    finally:
        ch.close()
        server.stop()


def test_rpcz_page_scope_pod_without_pod():
    server = _server(PORT, f"mem://obs_nopod_{next(_names)}")
    try:
        _ctype, body = server._builtin.dispatch("rpcz", {"scope": "pod"})
        assert "requires a joined pod" in body
        _ctype, body = server._builtin.dispatch("rpcz", {"trace_id": "ab"})
        assert "spans" in json.loads(body)
    finally:
        server.stop()


def test_ici_page_counts_agree_with_the_plane():
    """The /ici page's plane and transport counters agree with the plane
    and the sockets; a transfer's timeline is kept with rpcz off too, as
    the JAX plane keeps it."""
    server = _server(PORT, "ici://4")
    ch = _channel(PORT, "ici://4")

    def echo_8k():
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(
            IciMesh.default().device_put(
                torch.zeros(8192, dtype=torch.uint8), 6))
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="p"),
                       EchoResponse)
        assert not cntl.failed()

    old = tflags.get_flag("rpcz_enabled")
    try:
        tflags.set_flag("ici_device_plane_threshold", 4096)
        tflags.set_flag("rpcz_enabled", False)
        moved0, dev0 = ici_transport.ici_transport_stats()
        recent0 = len(dp.plane().recent_transfers())
        transfers0 = dp.plane().stats()["transfers"]
        echo_8k()
        recent = dp.plane().recent_transfers()
        made = dp.plane().stats()["transfers"] - transfers0
        assert made >= 1
        assert len(recent) == min(64, recent0 + made)
        assert recent[-1]["state"] == "complete"
        moved1, dev1 = ici_transport.ici_transport_stats()
        assert dev1 - dev0 == 8192          # the request's attachment
        assert moved1 - moved0 > dev1 - dev0
        tflags.set_flag("rpcz_enabled", True)
        echo_8k()
        page = json.loads(_builtin(PORT, ch, "ici")["body"])
        assert page["device_plane"]["transfers"] == \
            dp.plane().stats()["transfers"] > 0
        assert page["device_plane_recent"][-1]["state"] == "complete"
        assert page["transport"]["device_bytes_moved"] >= dev1 + 8192
    finally:
        tflags.set_flag("rpcz_enabled", old)
        ch.close()
        server.stop()


def test_ici_page_keeps_untraced_timelines_on_both_packages():
    """With rpcz off, both packages' /ici pages keep the finished
    transfers' timelines (the last 64), and their byte totals grow by the
    attachment each call carried."""
    import jax
    from brpc_tpu.ici import device_plane as jdp
    from brpc_tpu.ici import transport as jtransport
    from brpc_tpu.ici.mesh import IciMesh as JaxMesh
    import numpy as np
    jsaved = {n: jflags.get_flag(n) for n in _FLAGS}
    tsaved = {n: tflags.get_flag(n) for n in _FLAGS}
    for f in (jflags, tflags):
        f.set_flag("rpcz_enabled", False)
        f.set_flag("ici_device_plane", True)
        f.set_flag("ici_device_plane_host_mesh", True)
        f.set_flag("ici_device_plane_threshold", 4096)
    data = np.arange(8192, dtype=np.uint8)
    got = {}
    try:
        for pkg, plane, stats in ((JAX, jdp.plane(),
                                   jtransport.ici_transport_stats),
                                  (PORT, dp.plane(),
                                   ici_transport.ici_transport_stats)):
            server = _server(pkg, "ici://6")
            ch = _channel(pkg, "ici://6")
            try:
                _, dev0 = stats()
                t0 = plane.stats()["transfers"]
                for i in range(3):
                    cntl = pkg.rpc.Controller()
                    if pkg is JAX:
                        arr = jax.device_put(data, JaxMesh.default().device(5))
                    else:
                        arr = IciMesh.default().device_put(
                            torch.from_numpy(data), 5)
                    cntl.request_attachment.append_device_array(arr)
                    ch.call_method("EchoService.Echo", cntl,
                                   pkg.Req(message="u"), pkg.Resp)
                    assert not cntl.failed(), cntl.error_text
                page = json.loads(_builtin(pkg, ch, "ici")["body"])
                made = plane.stats()["transfers"] - t0
                recent = page["device_plane_recent"]
                got[pkg.name] = (made, stats()[1] - dev0,
                                 [(r["nbytes"], r["state"])
                                  for r in recent[-made:]])
            finally:
                ch.close()
                server.stop()
    finally:
        for n, v in jsaved.items():
            jflags.set_flag(n, v)
        for n, v in tsaved.items():
            tflags.set_flag(n, v)
    assert got["jax"] == got["torch"] == (3, 3 * 8192,
                                          [(8192, "complete")] * 3)


def test_ici_byte_totals_count_a_write_racing_its_close():
    """A write that finishes after its socket began to close is counted:
    the close folds the socket's counters under its write lock, and the
    late write adds to the folded totals."""
    server = _server(PORT, "ici://7")
    from brpc_tpu_torch.butil.endpoint import parse_endpoint
    from brpc_tpu_torch.butil.iobuf import IOBuf
    sock = ici_transport.ici_connect(parse_endpoint("ici://7"))
    try:
        moved0, dev0 = ici_transport.ici_transport_stats()
        relocate = sock._relocate

        def relocate_then_close(frame):
            out = relocate(frame)
            # the close lands while this write is still in _do_write
            threading.Thread(target=sock.set_failed).start()
            deadline = time.monotonic() + 5
            while not sock._counters_folded and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            return out

        sock._relocate = relocate_then_close
        buf = IOBuf()
        buf.append(b"h" * 100)
        buf.append_device_array(IciMesh.default().device_put(
            torch.zeros(8192, dtype=torch.uint8), 0))
        sock.write(buf)
        deadline = time.monotonic() + 5
        while ici_transport.ici_transport_stats()[0] - moved0 < 8292 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        moved, dev = ici_transport.ici_transport_stats()
        assert sock._counters_folded
        assert (moved - moved0, dev - dev0) == (8292, 8192)
    finally:
        sock.set_failed()
        server.stop()
