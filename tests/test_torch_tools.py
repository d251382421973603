"""The operator tools on both packages: ``TestRpcPress``, ``TestRpcView``
and ``TestParallelHttp`` of ``tests/test_tools.py`` over ``brpc_tpu`` and
over ``brpc_tpu_torch`` (``tests/torch_mirror.py``), then the port's twin
of ``tests/test_serving.py::TestServingServices::test_rpc_press_serving_mode``
and the summaries' keys and deterministic counts compared across the two
packages on the same in-process servers.

No swap: the file's imports map one for one, and ``tests/echo_pb2`` is
plain protobuf that either package's server takes.  The port's copy runs
with a CPU mesh as the default (``IciMesh(ranks=8, device="cpu")``, the
flag ``ici_device_plane_host_mesh`` on): ``test_press_fanout_mode``'s four
``ici://`` servers and the fan-out operand live on it, where the JAX copy
uses the JAX package's CPU devices.

Left out: ``TestRpcDumpAndReplay`` (``names=``).  The dump and its replay
are held on both packages by ``tests/test_torch_rpc_dump.py``, byte for
byte, and the JAX ``rpc_dump`` keeps its open file across a change of
``rpc_dump_dir`` (so a second copy of the case writes into the first
one's directory).
"""
from __future__ import annotations

import io
import json

import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)


@pytest.fixture(scope="module", autouse=True)
def port_cpu_mesh():
    """The port's default mesh on the CPU, the device plane engaged on
    it; both put back at the module's end."""
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici.mesh import IciMesh
    names = ("ici_device_plane", "ici_device_plane_host_mesh")
    saved = {n: flags.get_flag(n) for n in names}
    IciMesh.set_default(IciMesh(ranks=8, device="cpu"))
    flags.set_flag("ici_device_plane", True)
    flags.set_flag("ici_device_plane_host_mesh", True)
    yield
    for n, v in saved.items():
        flags.set_flag(n, v)
    IciMesh.set_default(None)


torch_mirror.mirror("tests/test_tools.py", globals(),
                    names=["TestRpcPress", "TestRpcView",
                           "TestParallelHttp"])


def _echo_server(pkg: str, name: str):
    """A ``mem://name`` echo server on package ``pkg``."""
    import importlib
    rpc = importlib.import_module(f"{pkg}.rpc")
    from tests.echo_pb2 import EchoRequest, EchoResponse

    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

    server = rpc.Server()
    server.add_service(Echo())
    assert server.start(f"mem://{name}") == 0
    return server


def _press_both(**kw) -> dict:
    """``run_press`` of each package against three ``mem://`` echo
    servers of its own package, the same arguments."""
    import importlib
    out = {}
    for pkg in ("brpc_tpu", "brpc_tpu_torch"):
        press = importlib.import_module(f"{pkg}.tools.rpc_press")
        names = [f"twin-press-{pkg}-{i}" for i in range(3)]
        servers = [_echo_server(pkg, n) for n in names]
        try:
            out[pkg] = press.run_press(
                ",".join(f"mem://{n}" for n in names), "EchoService.Echo",
                '{"message":"p"}',
                proto="tests.echo_pb2:EchoRequest,EchoResponse",
                out=io.StringIO(), **kw)
        finally:
            for s in servers:
                s.stop()
        out[pkg]["names"] = names
    return out


def test_press_summaries_have_jax_keys_and_counts():
    """The same throttled, mixed-class press on both packages gives the
    same summary keys, the same per-endpoint and per-class keys, and the
    throttle's count within one tick a worker of the other's."""
    got = _press_both(qps=40, duration=0.5, concurrency=2,
                      priority="0:1,3:1", tenant="a:1,b:2")
    jax_r, port_r = got["brpc_tpu"], got["brpc_tpu_torch"]
    skip = {"names", "routes"}          # routes: only what moved bytes
    assert set(jax_r) - skip == set(port_r) - skip
    assert set(jax_r["usercode_pool_stats"]) == \
        set(port_r["usercode_pool_stats"]) == {"isolation", "servers"}
    assert set(jax_r["usercode_pool_stats"]["isolation"]) == \
        set(port_r["usercode_pool_stats"]["isolation"])
    for r in (jax_r, port_r):
        assert r["errors"] == 0
        assert [k.split("-")[-1] for k in r["per_endpoint"]] == \
            ["0", "1", "2"]
        # the wheels' lengths 2 and 3 draw every (band, tenant) pair
        assert sorted(r["per_class"]) == ["p0/a", "p0/b", "p3/a", "p3/b"]
        assert set(next(iter(r["per_class"].values()))) == {
            "sent", "shed", "errors", "avg_latency_us", "p99_latency_us"}
        assert set(next(iter(r["per_endpoint"].values()))) == {
            "sent", "errors", "qps"}
    # 40 qps over 2 workers for 0.5 s: each worker fires at 0, 50, ...,
    # 450 ms, 10 calls; the count is the throttle's, not the host's
    assert abs(jax_r["sent"] - port_r["sent"]) <= 2, (jax_r, port_r)
    assert 16 <= port_r["sent"] <= 22


def test_fanout_and_sigint_guards_match_jax():
    """The weighted-mix parser, the pins' refusals and the fan-out's
    member check are the JAX tool's."""
    from brpc_tpu.tools import rpc_press as jp
    from brpc_tpu_torch.tools import rpc_press as tp
    for spec, ints in (("a:2,b:1", False), ("0:1,3:3", True), ("x", False)):
        assert jp.parse_weighted_mix(spec, int_keys=ints) == \
            tp.parse_weighted_mix(spec, int_keys=ints)
    for bad in ("a:0", "a:x"):
        for mod in (jp, tp):
            with pytest.raises(SystemExit):
                mod.parse_weighted_mix(bad)
    assert jp.BULK_PLANES == tp.BULK_PLANES
    assert jp.USERCODE_POOLS == tp.USERCODE_POOLS
    for mod in (jp, tp):
        with pytest.raises(SystemExit, match="needs 4 members"):
            mod.run_press_fanout("mem://a,mem://b", "Fan.Press", 4,
                                 duration=0.1, out=io.StringIO())


class TestServingPressPort:
    """The port's twin of ``tests/test_serving.py::TestServingServices::
    test_rpc_press_serving_mode``: prefill on ``ici://7`` of the CPU
    mesh, the decode worker and the router on ``mem://``."""

    def test_rpc_press_serving_mode(self):
        from brpc_tpu_torch.examples.disagg_serving.workers import (
            close_services, start_decode_worker, start_prefill_worker,
            start_router)
        from brpc_tpu_torch.tools.rpc_press import run_press_serving
        prefill = start_prefill_worker("ici://7")
        decode = start_decode_worker("mem://press-dec-port", rank=6)
        router = start_router("mem://press-router-port", "ici://7",
                              ["mem://press-dec-port"])
        try:
            res = run_press_serving(
                "mem://press-router-port", duration=1.5, arrival_rps=40.0,
                batch_ratio=2, seq_range="16-32", steps_range="4-16",
                verify=True, out=io.StringIO())
            assert res["issued"] >= 20, res
            assert res["mismatches"] == 0, res
            for tenant in ("inter", "bulk"):
                c = res["per_tenant"][tenant]
                assert c["ok"] > 0 and c["failures"] == 0, res
                assert c["session_tokens_per_s_p50"] > 0, res
            assert res["tokens_per_s"] > 0
            blk = next(v for k, v in res["serving_status"].items()
                       if "Decode" in k)
            assert blk["pool"]["blocks_total"] > 0
            assert blk["scheduler"]["steps"] > 0
            pfx = next(v for k, v in res["kv_prefix"].items()
                       if "Decode" in k)
            assert pfx["sharing_ratio"] >= 1.0
            assert pfx["unlocked_fills"] > 0
            for key in ("shared_blocks", "prefix_hits", "cow_splits"):
                assert key in pfx
            tiers = next(v for k, v in res["kv_tiers"].items()
                         if "Decode" in k)
            for key in ("demotions", "restores", "restore_p50_us",
                        "spilled_sessions", "migration"):
                assert key in tiers
            assert tiers["migration"]["scope"] == "process"
            assert set(res["kv_load_routes"]) >= {"adopted", "scattered",
                                                  "materialized"}
            assert json.dumps(res)
        finally:
            close_services(router, prefill, decode)
