"""Kind 1, the fabric's unsequenced transfer pull, against the JAX package.

* the route table: the ``xfer`` row after ``shm`` and ``bulk``, for DEVICE
  payloads the device plane does not take, over every class, size and
  plane health, equal to the JAX table;
* the fault plan: ``xfer_refuse_stages`` decides and counts as the JAX
  plan does, and ``plane_slow_ms`` takes ``"xfer"`` as the JAX plan does;
* the xfer plane record: a refused stage's transitions (down, the timer
  latch, the re-probe, the revival) equal the JAX record's;
* two processes: with the shm ring and the bulk conn off for the pair,
  DEVICE payloads below ``ici_device_plane_threshold`` cross as kind 1 both
  ways; in each process ``p2p_copy`` launches = kind-1 rows pulled =
  attachments received, every echo equals its request, PULLED drains
  ``_staged``, and a refusal budget sends exactly that many stages inline
  with no failed call.
"""
from __future__ import annotations

import threading
import time

import pytest

from brpc_tpu.ici import fabric as _jfabric  # noqa: F401  (flags)
from brpc_tpu.ici import plane_health as jph
from brpc_tpu.ici import route as jroute
from brpc_tpu.rpc import fault_injection as jfi
from brpc_tpu_torch.ici import fabric as _tfabric  # noqa: F401
from brpc_tpu_torch.ici import plane_health as tph
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.rpc import fault_injection as tfi
from tests.torch_procs import ok, run_procs


class _RouteSock:
    def __init__(self, shm, bulk, xfer, eligible=False):
        self.health = {"shm": shm, "bulk": bulk, "xfer": xfer}
        self.eligible = eligible

    def plane_usable(self, plane, nbytes=0):
        h = self.health.get(plane)
        if plane == "shm" and h == "small":
            return nbytes + 48 <= 1 << 20
        return bool(h)

    def dplane_eligible(self, nbytes):
        return self.eligible


@pytest.mark.parametrize("cls", [troute.HOST, troute.DEVICE,
                                 troute.STREAM])
def test_route_rows_with_xfer_equal_jax(cls):
    n = 0
    for size in (0, 100, 65535, 65536, 1 << 20, 40 << 20):
        for shm in (True, False, "small"):
            for bulk in (True, False):
                for xfer in (True, False):
                    sock = _RouteSock(shm, bulk, xfer)
                    got = troute.candidates(sock, cls, size)
                    assert got == jroute.candidates(sock, cls, size), \
                        (cls, size, shm, bulk, xfer)
                    if cls == troute.DEVICE and xfer and size >= 65536:
                        assert got[-2:] == [troute.XFER, troute.INLINE]
                    n += 1
    assert n == 72
    assert troute.XFER == jroute.XFER


def test_xfer_stage_refusals_decide_as_jax():
    class _S:
        pass
    out = {}
    for name, fi in (("jax", jfi), ("port", tfi)):
        mine = _S()
        plan = fi.FabricFaultPlan(xfer_refuse_stages=2,
                                  match=lambda s, mine=mine: s is mine)
        seq = [plan.on_xfer_stage(_S()), plan.on_xfer_stage(mine),
               plan.on_xfer_stage(), plan.on_xfer_stage(mine),
               plan.on_xfer_stage(mine)]
        out[name] = (seq, plan.injected)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, True, True, False, False]
    assert out["port"][1]["xfer"] == 2


def test_plane_slow_takes_xfer_as_jax():
    for fi in (jfi, tfi):
        plan = fi.FabricFaultPlan(plane_slow_ms={"xfer": 5})
        assert plan.plane_slow_ms == {"xfer": 5}
    with pytest.raises(ValueError):
        tfi.FabricFaultPlan(plane_slow_ms={"bogus": 5})
    assert set(tfi.FabricFaultPlan().injected) \
        == set(jfi.FabricFaultPlan().injected)


def test_xfer_record_transitions_equal_jax():
    """The socket's xfer record (a probe and the timer latch): a refused
    stage marks it down, the route skips it while latched, the first use
    after the window re-probes and revives it; a second refusal latches
    it again.  Snapshots and the plane counters move as the JAX record's."""
    out = {}
    for name, ph, route in (("jax", jph, jroute), ("port", tph, troute)):
        label = f"tx1_{name}"
        usable = [True]
        rec = ph.register_plane(label, threading.Lock(),
                                probe=lambda n: usable[0],
                                retry_s=lambda: 0.05)
        before = route.plane_stats()
        steps = [rec.usable(4096)]
        steps.append(rec.mark_down("injected stage refusal"))
        steps.append(rec.usable(4096))
        time.sleep(0.08)
        steps.append(rec.usable(4096))
        steps.append(rec.mark_down("injected stage refusal"))
        steps.append(rec.usable(4096))
        time.sleep(0.08)
        usable[0] = False                  # the peer lost its advert
        steps.append(rec.usable(4096))
        snap = rec.snapshot()
        after = route.plane_stats()
        events = {k[len(label) + 1:]: after[k] - before.get(k, 0)
                  for k in after if k.startswith(label + "_")}
        out[name] = (steps, snap["state"], snap["downs"], events)
    assert out["port"] == out["jax"]
    assert out["port"][0][:4] == [True, True, False, True]


_KIND1 = r"""
import importlib
from brpc_tpu_torch.ici import fabric
from brpc_tpu_torch.rpc import fault_injection as fi
flags.set_flag("ici_fabric_shm", False)
flags.set_flag("ici_fabric_bulk", False)
flags.set_flag("ici_device_plane_threshold", 1 << 20)
fabric.DEVICE_RETRY_S = 0.3
p2p = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
launches = []
_real = p2p.p2p_copy_plain
def _counted(s, d):
    launches.append(s.numel())
    return _real(s, d)
p2p.p2p_copy_plain = _counted
SIZES = [4096, 65536, 4096, 65536, 200000]
got = []

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        got.append(len(cntl.request_attachment))
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()

def staged():
    return sum(len(s._staged) for s in fabric_socks())

out = {}
if pid == 0:
    server = rpc.Server(rpc.ServerOptions(native_ici=False))
    server.add_service(Echo())
    assert server.start("ici://0") == 0
    put("up", 1)
    get("client_done", 120)
    out["received"] = got
else:
    get("up")
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=20000,
                                                  max_retry=0))
    def call(i, n):
        data = torch.arange(n, dtype=torch.int64).add(i).remainder(251) \
            .to(torch.uint8)
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(mesh.own(data, 2))
        resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message=str(i)),
                              EchoResponse)
        back = cntl.response_attachment.to_bytes() if not cntl.failed() \
            else b""
        return [cntl.failed(), cntl.error_code_,
                resp is not None and resp.message == str(i),
                back == bytes(data.numpy())]
    out["xfer_calls"] = [call(i, n) for i, n in enumerate(SIZES)]
    out["launches_xfer"] = len(launches)
    out["route_xfer"] = route.route_stats()
    s = fabric_socks()[0]
    out["planes_before"] = s.describe_planes()["xfer"]["state"]
    # the refusal budget: the first stage refused marks the plane down
    # (the next call rides inline without asking the plan), the window
    # passes, the re-probe's stage is refused again, then kind 1 returns
    plan = fi.FabricFaultPlan(xfer_refuse_stages=2)
    fi.install_fabric(plan)
    r0 = route.route_stats()
    refused = [call(10, 65536), call(11, 65536)]
    time.sleep(0.4)
    refused.append(call(12, 65536))
    time.sleep(0.4)
    refused.append(call(13, 65536))
    fi.install_fabric(None)
    r1 = route.route_stats()
    out["refused_calls"] = refused
    out["injected"] = plan.injected["xfer"]
    out["inline_bytes"] = r1.get("inline_bytes", 0) \
        - r0.get("inline_bytes", 0)
    out["xfer_frames"] = r1.get("xfer_frames", 0) \
        - r0.get("xfer_frames", 0)
    out["plane_events"] = {k: v for k, v in route.plane_stats().items()
                           if k.startswith("xfer_")}
    ch.close()
    put("client_done", 1)
end = time.time() + 5
while staged() and time.time() < end:
    time.sleep(0.01)
out["staged_left"] = staged()
out["launches"] = len(launches)
out["xfer"] = fabric.xfer_stats()
out["foreign"] = foreign()
result(out)
finish()
"""


def test_kind1_two_processes_launches_pulls_and_refusals():
    srv, cli = ok(run_procs(_KIND1, 2, timeout=120))
    sizes = [4096, 65536, 4096, 65536, 200000]
    assert srv["foreign"] == cli["foreign"] == []
    assert cli["xfer_calls"] == [[False, 0, True, True]] * len(sizes)
    assert cli["refused_calls"] == [[False, 0, True, True]] * 4
    # the server pulled every request's row, the client every response's:
    # launches = kind-1 rows pulled = attachments received, per process
    n_srv = len(srv["received"])
    assert srv["received"][:len(sizes)] == sizes
    assert srv["launches"] == srv["xfer"]["pulled"] == n_srv - 3
    assert cli["launches_xfer"] == len(sizes)
    assert cli["launches"] == cli["xfer"]["pulled"] == len(sizes) + 1
    # PULLED released every stage; nothing is left pinned
    assert srv["staged_left"] == cli["staged_left"] == 0
    for side in (srv, cli):
        assert side["xfer"]["staged"] == side["xfer"]["acked"]
    assert cli["xfer"]["staged"] == srv["xfer"]["pulled"]
    assert srv["xfer"]["staged"] == cli["xfer"]["pulled"]
    assert cli["route_xfer"]["xfer_frames"] == len(sizes)
    assert cli["route_xfer"]["xfer_bytes"] == sum(sizes)
    # the budget exact: two stages refused, three payloads inline (the
    # second call found the plane latched; each frame's header rides
    # inline too), the last call on kind 1
    assert cli["injected"] == 2
    assert cli["xfer"]["refused"] == 2
    assert 3 * 65536 < cli["inline_bytes"] < 4 * 65536
    assert cli["xfer_frames"] == 1
    assert cli["planes_before"] == tph.UP
    assert cli["plane_events"]["xfer_down"] == 2
    assert cli["plane_events"]["xfer_revived"] >= 1
