"""The compiled collective fan-out's local leg (channels/collective_fanout.py)
held against the JAX package on the CPU.

Mirrors ``tests/test_collective_fanout.py``'s local-leg cases on both
stacks: the JAX servers on its 8-device CPU mesh, the port's on
``IciMesh(ranks=8, device="cpu")`` with the device plane engaged, so a
DEVICE row or answer of the per-member loop crosses on ``p2p_copy``'s
plain version.

  * screen: each ineligible call declines with the same reason on both
    and adds the same ``collective_stats()`` deltas;
  * parity: shard/gather and concat bit-exact, replicate/sum within
    rtol = atol = 1e-6 (bit-exact on integer-valued data), MERGE_NONE's
    rows, ``takes_index`` over a permuted device order — each compiled in
    the port, degraded in the port and compiled in JAX;
  * the port's async ``done`` path, PartitionChannel lowering,
    SelectiveChannel propagation and concurrent fan-outs serialized with
    ``assigned == executed``;
  * a member killed mid-fan-out (N = 4) on both stacks with equal
    counter deltas; the transient reprobe on its timer, the screen cache
    invalidated by a re-init, the transient-failure budget;
  * the degrade leg on ``ici://``: its plain ``p2p_copy`` calls equal the
    plane's transfers.
"""
from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import channels as jchannels
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import flags as jflags
from brpc_tpu.channels import collective_fanout as jcf
from brpc_tpu.ici import route as jroute
from brpc_tpu.rpc import fault_injection as jfi
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.channels import collective_fanout as tcf
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors, health_check, lameduck
from brpc_tpu_torch.rpc import fault_injection as tfi
from brpc_tpu_torch.rpc.circuit_breaker import BreakerRegistry
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import EchoRequest as JEchoRequest
from tests.echo_pb2 import EchoResponse as JEchoResponse

SHARD = 128
N = 4
# method names of their own: the JAX registry is process-wide, and the
# JAX package's own fan-out tests register Fan.*
SCALE, ACCUM, CAT, KEEP, IDX, BAD = ("TFan.Scale", "TFan.Accum", "TFan.Cat",
                                     "TFan.Keep", "TFan.Idx", "TFan.Bad")
PERMUTED = (3, 1, 0, 2)
_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold", "ici_fanout_collective",
          "ici_fanout_reprobe_s")


def _att_array(att, np_dtype):
    """A request or response attachment as a numpy array: DEVICE blocks
    (the port) or bytes (numpy operands, the JAX package)."""
    refs = att.device_refs() if hasattr(att, "device_refs") else []
    if refs and len(refs) == 1 and refs[0].length == len(att):
        r = refs[0]
        t = r.block.data[r.offset:r.offset + r.length]
        return t.numpy().view(np_dtype), t
    return np.frombuffer(att.to_bytes(), np_dtype).copy(), None


def _wire_service(pkg, rank: int):
    """The wire bodies: the same semantics as the device handlers.  A
    DEVICE request comes back as a DEVICE answer owned by this rank,
    bytes as bytes."""

    def reply(cntl, y, dev_in):
        if dev_in is not None:
            mesh = IciMesh.default()
            out = torch.from_numpy(np.ascontiguousarray(y)).view(torch.uint8)
            cntl.response_attachment.append_device_array(
                mesh.own(out.reshape(-1).clone(), rank))
        else:
            cntl.response_attachment.append(
                np.ascontiguousarray(y).tobytes())

    class TFan(pkg.rpc.Service):
        SERVICE_NAME = "TFan"

        def _body(self, cntl, fn, np_dtype=np.float32):
            x, dev_in = _att_array(cntl.request_attachment, np_dtype)
            reply(cntl, fn(x).astype(np_dtype), dev_in)

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Scale(self, cntl, request, response, done):
            self._body(cntl, lambda x: x * 2.0)
            response.message = "ok"
            done()

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Accum(self, cntl, request, response, done):
            self._body(cntl, lambda x: x + 1.0)
            done()

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Cat(self, cntl, request, response, done):
            self._body(cntl, lambda x: x * 3.0)
            done()

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Keep(self, cntl, request, response, done):
            self._body(cntl, lambda x: x - 1.0)
            done()

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Idx(self, cntl, request, response, done):
            # the wire body learns its fan-out position from its rank
            i = PERMUTED.index(rank)
            self._body(cntl, lambda x: x * (i + 1))
            done()

    return TFan()


def _register(server) -> None:
    server.register_collective(SCALE, lambda x: x * 2.0, merge="gather",
                               mapping="shard")
    server.register_collective(ACCUM, lambda x: x + 1.0, merge="sum",
                               mapping="replicate")
    server.register_collective(CAT, lambda x: x * 3.0, merge="concat",
                               mapping="shard")
    server.register_collective(KEEP, lambda x: x - 1.0, merge="none",
                               mapping="shard")
    server.register_collective(IDX, lambda i, x: x * (i + 1),
                               merge="gather", mapping="shard",
                               takes_index=True)


def _start(pkg, dev: int):
    s = pkg.rpc.Server()
    s.add_service(_wire_service(pkg, dev))
    _register(s)
    assert s.start(f"ici://{dev}") == 0
    return s


def _to_operand(pkg, op):
    return op if pkg.name == "jax" else torch.from_numpy(op.copy())


JAX = types.SimpleNamespace(
    name="jax", rpc=jrpc, channels=jchannels, cf=jcf, route=jroute,
    fi=jfi, flags=jflags, Req=JEchoRequest, Resp=JEchoResponse)
PORT = types.SimpleNamespace(
    name="torch", rpc=rpc, channels=channels, cf=tcf, route=troute,
    fi=tfi, flags=tflags, Req=EchoRequest, Resp=EchoResponse)
STACKS = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def stacks():
    """Both stacks' servers on ici://0-7, the port on a CPU mesh with the
    plane engaged.  At teardown the port's sockets, server Controllers
    and plane pins are all returned and the routes are healthy."""
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 64)
    servers = {(pkg.name, d): _start(pkg, d)
               for pkg in STACKS for d in range(8)}
    yield servers
    for s in servers.values():
        s.stop()
    for pkg in STACKS:
        _healthy(pkg)
    for n, v in saved.items():
        tflags.set_flag(n, v)
    IciMesh.set_default(None)
    deadline = time.monotonic() + 2.0
    plane = dp.DevicePlane._instance
    while (rpc.list_sockets() or server_controller_pool.live()
           or (plane is not None and plane.active_transfers())) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


_chans = []


@pytest.fixture(autouse=True)
def close_channels():
    """Close the port's channels, and undo what a stopped member leaves
    behind (a health check probing it, an isolated breaker, a drain
    mark), so a later test in the worker starts clean."""
    yield
    while _chans:
        _chans.pop().close()
    for ep in list(health_check._tasks):
        health_check._tasks[ep].cancel()
    for ep in lameduck.peer_draining():
        lameduck.clear_peer_draining(ep)
    reg = BreakerRegistry.instance()
    with reg._lock:
        breakers = list(reg._map.values())
    for b in breakers:
        if b.is_isolated():
            b.mark_recovered()


def _healthy(pkg) -> None:
    """Start route-up: a previous degrade must not leak into this test."""
    plane = pkg.cf.CollectiveFanoutPlane.instance()
    if plane.health()["down"]:
        pkg.cf.registry().serve(99)      # any transition moves the epoch
        pkg.cf.registry().withdraw(99)
        assert plane.route_usable()


def _channel(pkg, dev):
    ch = pkg.rpc.Channel()
    ch.init(f"ici://{dev}", options=pkg.rpc.ChannelOptions(timeout_ms=15000))
    if pkg is PORT:
        _chans.append(ch)
    return ch


def _fanout(pkg, devs, method=SCALE, mapper=None, merger=None):
    pc = pkg.channels.ParallelChannel()
    merge = {SCALE: "gather", ACCUM: "sum", CAT: "concat", KEEP: "none",
             IDX: "gather"}.get(method, "gather")
    if mapper is None:
        mapper = (pkg.channels.ReplicateFanoutMapper() if method == ACCUM
                  else pkg.channels.ShardingCallMapper())
    if merger is None:
        merger = pkg.channels.CollectiveMerger(
            merge=merge, dtype="float32",
            shard_shape=None if method == ACCUM else (SHARD,))
    for d in devs:
        pc.add_channel(_channel(pkg, d), mapper=mapper, merger=merger)
    return pc


def _call(pkg, pc, operand, method=SCALE, ok=True):
    cntl = pkg.rpc.Controller()
    cntl.fanout_operand = operand
    pc.call_method(method, cntl, pkg.Req(message="x"), pkg.Resp())
    if ok:
        assert not cntl.failed(), (cntl.error_code_, cntl.error_text_)
    return cntl


def _stats(pkg) -> dict:
    return dict(pkg.route.collective_stats())


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Screen.
# ---------------------------------------------------------------------------

def _screen_plain(pkg):
    pc = pkg.channels.ParallelChannel()
    for d in range(N):
        pc.add_channel(_channel(pkg, d))
    cntl = pkg.rpc.Controller()
    pc.call_method(SCALE, cntl, pkg.Req(message="x"), pkg.Resp())
    assert not cntl.failed()
    return cntl.fanout_route, None


def _screen_unregistered(pkg):
    pc = _fanout(pkg, range(N))
    cntl = _call(pkg, pc, _to_operand(pkg, np.ones((N, SHARD), np.float32)),
                 method="TFan.Nope", ok=False)
    return cntl.fanout_route, None


def _screen_custom_mapper(pkg):
    class MyMapper(pkg.channels.ShardingCallMapper):
        collective_mapping = None

    pc = _fanout(pkg, range(N), mapper=MyMapper())
    op = np.ones((N, SHARD), np.float32)
    cntl = _call(pkg, pc, _to_operand(pkg, op))
    return cntl.fanout_route, _np(cntl.fanout_result)


def _screen_merge_mismatch(pkg):
    merger = pkg.channels.CollectiveMerger(merge="sum", dtype="float32")
    pc = _fanout(pkg, range(N), merger=merger)
    op = np.ones((N, SHARD), np.float32)
    cntl = _call(pkg, pc, _to_operand(pkg, op))
    return cntl.fanout_route, _np(cntl.fanout_result)


def _screen_wrong_shard_count(pkg):
    pc = _fanout(pkg, range(N))
    pc.fail_limit = 1
    cntl = _call(pkg, pc, _to_operand(pkg, np.ones((N - 1, SHARD),
                                                   np.float32)), ok=False)
    assert cntl.failed()
    return cntl.fanout_route, cntl.error_code_


def _screen_unserved_device(pkg, servers):
    servers[(pkg.name, 5)].stop()
    try:
        pc = _fanout(pkg, [0, 1, 2, 5])
        cntl = _call(pkg, pc, _to_operand(pkg, np.ones((N, SHARD),
                                                       np.float32)),
                     ok=False)
        return cntl.fanout_route, None
    finally:
        servers[(pkg.name, 5)] = _start(pkg, 5)


_SCREENS = {"plain": _screen_plain, "unregistered": _screen_unregistered,
            "custom_mapper": _screen_custom_mapper,
            "merge_mismatch": _screen_merge_mismatch,
            "wrong_shard_count": _screen_wrong_shard_count,
            "unserved_device": _screen_unserved_device}


@pytest.mark.parametrize("case", list(_SCREENS))
def test_screen_declines_alike(case, stacks):
    """Each ineligible call declines on both stacks: the same route, the
    same counter deltas (the reason's ``collective_ineligible_<reason>``),
    and, where the per-member loop completes, the same result."""
    out = {}
    for pkg in STACKS:
        _healthy(pkg)
        before = _stats(pkg)
        fn = _SCREENS[case]
        res = fn(pkg, stacks) if case == "unserved_device" else fn(pkg)
        out[pkg.name] = (res, _delta(before, _stats(pkg)))
    (jroute_, jres), jdelta = out["jax"]
    (troute_, tres), tdelta = out["torch"]
    assert troute_ == jroute_ == ("" if case == "plain" else "rpc")
    assert tdelta == jdelta
    if case == "wrong_shard_count":
        assert tres == jres == errors.ETOOMANYFAILS
    elif jres is not None:
        np.testing.assert_array_equal(tres, jres)


@pytest.mark.parametrize("rank0_serving", [False, True],
                         ids=["rank0_down", "rank0_up"])
def test_screen_checks_local_liveness_before_a_rank_past_the_mesh(
        rank0_serving, stacks):
    """A fan-out over ``[0, 99]`` (rank 99 past the 8-rank mesh): the
    screen checks this process's members first and the mesh bound only for
    remote ranks, as ``brpc_tpu/channels/collective_fanout.py:613-628``
    does.  With rank 0 not serving both packages decline ``member_down``,
    with it serving ``target_not_ici``, and each counts the same
    ``collective_ineligible_<reason>``."""
    from brpc_tpu.butil import endpoint as jep
    from brpc_tpu_torch.butil import endpoint as tep
    out = {}
    for pkg, ep_mod in ((JAX, jep), (PORT, tep)):
        _healthy(pkg)
        if not rank0_serving:
            stacks[(pkg.name, 0)].stop()
        try:
            mapper = pkg.channels.ShardingCallMapper()
            merger = pkg.channels.CollectiveMerger(
                merge="gather", dtype="float32", shard_shape=(SHARD,))
            subs = [(types.SimpleNamespace(
                _endpoint=ep_mod.parse_endpoint(f"ici://{d}")),
                mapper, merger) for d in (0, 99)]
            pchan = types.SimpleNamespace(_subs=subs)
            cntl = pkg.rpc.Controller()
            cntl.fanout_operand = _to_operand(
                pkg, np.ones((2, SHARD), np.float32))
            before = _stats(pkg)
            plane = pkg.cf.CollectiveFanoutPlane.instance()
            low, reason = plane.screen(subs, SCALE, cntl, pchan=None)
            handled = pkg.cf.maybe_call(pchan, SCALE, cntl,
                                        pkg.Req(message="x"), pkg.Resp(),
                                        None)
            out[pkg.name] = (low is None, reason, handled,
                             cntl.fanout_route, _delta(before, _stats(pkg)))
        finally:
            if not rank0_serving:
                stacks[(pkg.name, 0)] = _start(pkg, 0)
    want = "target_not_ici" if rank0_serving else "member_down"
    assert out["torch"] == out["jax"]
    assert out["jax"][:4] == (True, want, False, "rpc")
    assert out["jax"][4] == {f"collective_ineligible_{want}": 1}


# ---------------------------------------------------------------------------
# Parity: compiled in the port, degraded in the port, compiled in JAX.
# ---------------------------------------------------------------------------

def _three_ways(method, op, devs=tuple(range(N))):
    """(port compiled, port degraded, JAX compiled) results as numpy."""
    _healthy(JAX)
    _healthy(PORT)
    jc = _call(JAX, _fanout(JAX, devs, method), op, method)
    assert jc.fanout_route == "collective"
    pc = _fanout(PORT, devs, method)
    tc = _call(PORT, pc, torch.from_numpy(op.copy()), method)
    assert tc.fanout_route == "collective"
    tflags.set_flag("ici_fanout_collective", False)
    try:
        td = _call(PORT, pc, torch.from_numpy(op.copy()), method)
    finally:
        tflags.set_flag("ici_fanout_collective", True)
    assert td.fanout_route == "rpc"
    return tc, td, jc


def test_shard_gather_bit_exact():
    op = np.random.default_rng(1).standard_normal((N, SHARD)).astype(
        np.float32)
    tc, td, jc = _three_ways(SCALE, op)
    want = _np(jc.fanout_result)
    assert want.shape == (N, SHARD)
    np.testing.assert_array_equal(_np(tc.fanout_result), want)
    np.testing.assert_array_equal(_np(td.fanout_result), want)


def test_concat_bit_exact():
    op = np.random.default_rng(2).standard_normal((N, SHARD)).astype(
        np.float32)
    tc, td, jc = _three_ways(CAT, op)
    want = _np(jc.fanout_result)
    assert want.shape == (N * SHARD,)
    np.testing.assert_array_equal(_np(tc.fanout_result), want)
    np.testing.assert_array_equal(_np(td.fanout_result), want)


@pytest.mark.parametrize("values", ["random", "integer"])
def test_replicate_sum(values):
    rng = np.random.default_rng(3)
    op = (rng.standard_normal(SHARD).astype(np.float32) if values == "random"
          else rng.integers(-64, 64, SHARD).astype(np.float32))
    tc, td, jc = _three_ways(ACCUM, op)
    want = _np(jc.fanout_result)
    assert want.shape == (SHARD,)
    if values == "integer":
        np.testing.assert_array_equal(_np(tc.fanout_result), want)
        np.testing.assert_array_equal(_np(td.fanout_result), want)
    else:
        np.testing.assert_allclose(_np(tc.fanout_result), want,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(td.fanout_result), want,
                                   rtol=1e-6, atol=1e-6)
    # the port's two legs fold in one order: equal bit for bit
    np.testing.assert_array_equal(_np(tc.fanout_result),
                                  _np(td.fanout_result))


def test_merge_none_rows_stay_with_their_ranks():
    op = np.random.default_rng(4).standard_normal((N, SHARD)).astype(
        np.float32)
    devs = (6, 4, 5, 7)
    tc, td, jc = _three_ways(KEEP, op, devs)
    want = _np(jc.fanout_result)
    assert want.shape == (N, SHARD)
    rows = tc.fanout_result
    assert isinstance(rows, tcf.FanoutRows) and rows.devices == devs
    mesh = IciMesh.default()
    assert [mesh.rank_of(r) for r in rows.rows] == list(devs)
    np.testing.assert_array_equal(_np(rows.stack()), want)
    # the per-member loop stacks the answers, as the JAX merger does
    np.testing.assert_array_equal(_np(td.fanout_result), want)


def test_takes_index_is_the_fanout_position():
    """A fan-out over ici://3,1,0,2: device 3 is index 0."""
    op = np.random.default_rng(5).standard_normal((N, SHARD)).astype(
        np.float32)
    tc, td, jc = _three_ways(IDX, op, PERMUTED)
    want = _np(jc.fanout_result)
    np.testing.assert_array_equal(
        want, op * np.arange(1, N + 1, dtype=np.float32)[:, None])
    np.testing.assert_array_equal(_np(tc.fanout_result), want)
    np.testing.assert_array_equal(_np(td.fanout_result), want)


# ---------------------------------------------------------------------------
# The port's own paths.
# ---------------------------------------------------------------------------

def test_async_done_compiled():
    _healthy(PORT)
    pc = _fanout(PORT, range(N))
    ev = threading.Event()
    out = {}

    def done(c):
        out["route"] = c.fanout_route
        out["ok"] = not c.failed()
        out["result"] = _np(c.fanout_result)
        ev.set()

    cntl = rpc.Controller()
    cntl.fanout_operand = torch.ones(N, SHARD)
    pc.call_method(SCALE, cntl, EchoRequest(message="x"), EchoResponse(),
                   done=done)
    assert ev.wait(30)
    assert out["route"] == "collective" and out["ok"]
    np.testing.assert_array_equal(out["result"],
                                  np.full((N, SHARD), 2.0, np.float32))


def test_partition_channel_lowers(tmp_path):
    """Each partition resolves to exactly one ici:// member."""
    _healthy(PORT)
    listing = tmp_path / "parts"
    listing.write_text("".join(f"ici://{d} 100 {d}/4\n" for d in range(N)))
    pc = channels.PartitionChannel()
    merger = channels.CollectiveMerger(merge="gather", dtype="float32",
                                       shard_shape=(SHARD,))
    assert pc.init(N, f"file://{listing}",
                   mapper=channels.ShardingCallMapper(), merger=merger) == 0
    try:
        deadline = time.time() + 10
        while not pc.partitions_ready() and time.time() < deadline:
            time.sleep(0.05)
        assert pc.partitions_ready()
        op = np.arange(N * SHARD, dtype=np.float32).reshape(N, SHARD)
        cntl = _call(PORT, pc, torch.from_numpy(op.copy()))
        assert cntl.fanout_route == "collective"
        np.testing.assert_array_equal(_np(cntl.fanout_result), op * 2.0)
    finally:
        pc.close()


def test_selective_channel_propagates():
    _healthy(PORT)
    sc = channels.SelectiveChannel()
    sc.add_channel(_fanout(PORT, range(N)))
    cntl = rpc.Controller()
    cntl.fanout_operand = torch.ones(N, SHARD)
    sc.call_method(SCALE, cntl, EchoRequest(message="x"), EchoResponse)
    assert not cntl.failed(), (cntl.error_code_, cntl.error_text_)
    assert cntl.fanout_route == "collective"
    np.testing.assert_array_equal(_np(cntl.fanout_result),
                                  np.full((N, SHARD), 2.0, np.float32))


def test_concurrent_fanouts_serialize():
    _healthy(PORT)
    pc = _fanout(PORT, range(N))
    op = torch.arange(N * SHARD, dtype=torch.float32).reshape(N, SHARD)
    errs = []

    def worker():
        try:
            for _ in range(4):
                c = _call(PORT, pc, op)
                assert c.fanout_route == "collective"
                assert torch.equal(c.fanout_result, op * 2.0)
        except Exception as e:      # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    d = tcf.CollectiveFanoutPlane.instance().sequencer.describe()
    assert d["assigned"] == d["executed"]


# ---------------------------------------------------------------------------
# Kill and revive; the transient reasons.
# ---------------------------------------------------------------------------

def _kill_revive(pkg, servers):
    """The JAX package's chaos leg (run_kill_revive, N = 4): the routes
    the calls took and the counter deltas."""
    _healthy(pkg)
    pc = _fanout(pkg, range(N))
    op = np.arange(N * SHARD, dtype=np.float32).reshape(N, SHARD)
    routes = []

    def call():
        c = _call(pkg, pc, _to_operand(pkg, op))
        np.testing.assert_array_equal(_np(c.fanout_result), op * 2.0)
        routes.append(c.fanout_route)

    base = _stats(pkg)
    call()
    victim = N // 2
    plan = pkg.fi.FabricFaultPlan(collective_kill_device=victim)
    pkg.fi.install_fabric(plan)
    try:
        call()                        # degraded in-call, zero failures
        call()                        # stays down, no second injection
        injected = plan.injected["collective"]
    finally:
        pkg.fi.install_fabric(None)
    call()                            # cleared, but no epoch move
    servers[(pkg.name, victim)].stop()
    c = _call(pkg, pc, _to_operand(pkg, op), ok=False)
    routes.append(c.fanout_route)     # the victim is gone: screened out
    servers[(pkg.name, victim)] = _start(pkg, victim)
    call()                            # revived by the restart's epoch
    d = pkg.cf.CollectiveFanoutPlane.instance().sequencer.describe()
    assert d["assigned"] == d["executed"]
    return routes, injected, _delta(base, _stats(pkg))


def test_member_kill_mid_fanout_degrades_and_revives_alike(stacks):
    jres = _kill_revive(JAX, stacks)
    tres = _kill_revive(PORT, stacks)
    assert tres == jres
    routes, injected, delta = tres
    assert routes == ["collective", "rpc", "rpc", "rpc", "rpc", "collective"]
    assert injected == 1
    assert delta["collective_degraded_member_killed"] == 1
    assert delta["collective_revived_member_killed"] == 1
    assert delta["collective_selected"] == 2


def test_transient_exec_failure_reprobes_on_timer():
    """A route downed by a transient reason (a body that raises) comes
    back after ``ici_fanout_reprobe_s`` with no epoch move."""
    _healthy(PORT)

    def bad_handler(x):
        raise ValueError("bad handler body")

    tcf.register_device_handler(BAD, bad_handler, merge="gather",
                                mapping="shard")
    op = torch.ones(N, SHARD)
    old = tflags.get_flag("ici_fanout_reprobe_s")
    tflags.set_flag("ici_fanout_reprobe_s", 0.05)
    try:
        before = _stats(PORT)
        cntl = _call(PORT, _fanout(PORT, range(N)), op, method=BAD,
                     ok=False)
        assert cntl.fanout_route == "rpc"
        health = tcf.CollectiveFanoutPlane.instance().health()
        assert health["down"] and health["reason"] == "exec_failed"
        time.sleep(0.1)
        c2 = _call(PORT, _fanout(PORT, range(N)), op)
        assert c2.fanout_route == "collective"
        delta = _delta(before, _stats(PORT))
        assert delta["collective_degraded_exec_failed"] == 1
        assert delta["collective_revived_exec_failed"] == 1
    finally:
        tflags.set_flag("ici_fanout_reprobe_s", old)


def test_screen_cache_invalidated_by_channel_reinit():
    _healthy(PORT)
    pc = channels.ParallelChannel()
    mapper = channels.ShardingCallMapper()
    merger = channels.CollectiveMerger(merge="gather", dtype="float32",
                                       shard_shape=(SHARD,))
    chans = [_channel(PORT, d) for d in range(N)]
    for ch in chans:
        pc.add_channel(ch, mapper=mapper, merger=merger)
    op = torch.ones(N, SHARD)
    assert _call(PORT, pc, op).fanout_route == "collective"
    # rebind sub 3 to a rank whose server registered nothing here
    chans[3].init("ici://9")
    cntl = _call(PORT, pc, op, ok=False)
    assert cntl.fanout_route == "rpc"


@pytest.mark.parametrize("pkg", STACKS, ids=["jax", "torch"])
def test_transient_exec_failures_budget(pkg):
    """collective_fail_execs: a burst of failures degrades once and never
    fails the call."""
    _healthy(pkg)
    pc = _fanout(pkg, range(N))
    plan = pkg.fi.FabricFaultPlan(collective_fail_execs=2)
    pkg.fi.install_fabric(plan)
    try:
        c = _call(pkg, pc, _to_operand(pkg, np.ones((N, SHARD), np.float32)))
        assert c.fanout_route == "rpc"
        assert plan.injected["collective"] == 1
    finally:
        pkg.fi.install_fabric(None)
    _healthy(pkg)


# ---------------------------------------------------------------------------
# The degrade leg rides the plane.
# ---------------------------------------------------------------------------

def test_degrade_leg_rides_the_plane_on_p2p_copy(monkeypatch):
    """The per-member loop of a tensor operand: rows go out as DEVICE
    blocks owned by the members (a reference pass) and each answer
    crosses back as one plane transfer, one plain ``p2p_copy`` each."""
    _healthy(PORT)
    p2p = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    calls = []
    real = p2p.p2p_copy_plain

    def counting(src, dst):
        calls.append(src.numel())
        return real(src, dst)

    monkeypatch.setattr(p2p, "p2p_copy_plain", counting)
    plane = dp.plane()
    op = np.random.default_rng(6).standard_normal((N, SHARD)).astype(
        np.float32)
    pc = _fanout(PORT, range(N))
    operand = tcf.shard_operand(range(N), torch.from_numpy(op))
    t0 = plane.stats()["transfers"]
    tflags.set_flag("ici_fanout_collective", False)
    try:
        c = _call(PORT, pc, operand)
    finally:
        tflags.set_flag("ici_fanout_collective", True)
    transfers = plane.stats()["transfers"] - t0
    assert c.fanout_route == "rpc"
    np.testing.assert_array_equal(_np(c.fanout_result), op * 2.0)
    assert len(calls) == transfers == N
    # the compiled leg moves nothing on the plane
    calls.clear()
    t0 = plane.stats()["transfers"]
    c = _call(PORT, pc, operand)
    assert c.fanout_route == "collective"
    assert len(calls) == plane.stats()["transfers"] - t0 == 0
