"""The port's dryrun entry points: the counterpart of the JAX package's
``__graft_entry__.py``.

``entry(device=None)``
    returns ``(fabric_step, (frames,))``: the device-side body of an ici://
    echo and all-reduce exchange, the program the data plane runs per tick.
    ``frames`` is ``(n, 4096)`` float32 sharded over the mesh, one row per
    rank; ``fabric_step`` transforms each rank's frame (``f + cumsum(f) *
    1e-6``), moves it one hop round the ring (``Collectives.ppermute``),
    sums it over the ranks (``Collectives.all_reduce``) and returns
    ``hopped + reduced / (1 + n)`` per rank.

``dryrun_multichip(n_devices, device=None, cross_process=True)``
    builds ``IciMesh(n_devices, device)`` and runs the distributed fabric
    step at ``d = 16`` (a tensor-parallel matvec summed, a data-parallel
    gradient mean, a sequence-parallel ring hop, an expert-parallel
    ``all_to_all``), then every leg of the reference's dryrun in its order,
    each asserting its result and its route:

      rpc_stack         an ``ici://0`` echo from rank 1, a CollectiveChannel
                        matvec, a 64 KiB echo through the device plane (its
                        transfers move; on the card ``p2p_copy`` launches
                        one per transfer) and a RingStream of 5 chunks;
      collective_fanout a 4-member compiled fan-out against the
                        ``ici_fanout_collective=False`` per-member loop,
                        byte-equal;
      native_door       the native front door and the Python plane answer
                        one echo byte-identically, counted on the native
                        listener (the reference's fused-dispatch leg: the
                        port has one native dispatch chain);
      serving, kv_prefix, kv_migration
                        the disaggregated-serving decode workers
                        (batched decode, prefix-shared KV blocks, a live
                        migration), every decode equal to
                        ``reference_generate``;
      fabric_stress, shm_tier, shm_striped
                        two processes: a child of this one (process 0)
                        and a ``tools/fabric_peer`` (process 1); concurrent
                        DEVICE and host payloads past the socket window,
                        byte-exact, a verified stream, then one shm ring
                        and four stripes with the routes read off the byte
                        counters (the shm legs print the reference's SKIP
                        when ``/dev/shm`` is missing);
      pod_membership    four ``tools/pod_peer`` members: pod:// naming, a
                        kill and a drain under traffic, one final epoch.

    A leg that cannot run on this mesh prints the reference's SKIP line and
    its reason; any other failure raises.  Returns ``{leg: {"wall_s",
    "launches", ...}}``, where ``launches`` counts this process's
    ``p2p_copy`` launches in the leg (the children's own counts are in
    their legs' entries).  ``cross_process=False`` runs the in-process legs
    only.

Both run on the card unless the caller passes ``device="cpu"``.  The
dryrun wants a fresh process, as the reference's does: a fabric node or
pod left by earlier work changes which ranks are local.

    python -m brpc_tpu_torch.graft_entry [--device cpu] [--n 8]

checks ``entry()``'s step against its float64 formula, runs the dryrun
and prints ``RESULT {"entry": ..., "legs": ...}`` as its last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import torch

from .ici.collective import Collectives
from .ici.mesh import IciMesh

FRAME_LEN = 4096
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cross-process legs' sizes on the card; the CPU runs them smaller
# (the reference's stress: 3 threads x 3 calls of 2 MiB DEVICE payloads,
# bounced back; here each thread also sends host payloads of that size)
FABRIC_SIZES = {"stress_threads": 3, "stress_calls": 6,
                "stress_device_bytes": 2 << 20, "stress_host_bytes": 2 << 20,
                "stream_chunks": 16, "stream_chunk": 256 << 10,
                "shm_calls": 16, "shm_bytes": 1 << 20}
FABRIC_SIZES_CPU = {"stress_threads": 3, "stress_calls": 6,
                    "stress_device_bytes": 64 << 10,
                    "stress_host_bytes": 256 << 10,
                    "stream_chunks": 16, "stream_chunk": 16 << 10,
                    "shm_calls": 8, "shm_bytes": 256 << 10}
POD_ATTACH = 64 << 10
CHILD_TIMEOUT_S = 300.0


def entry(device: Optional[str] = None):
    """``(fabric_step, (frames,))`` over the default mesh, or over
    ``IciMesh(8, device)`` when ``device`` is given."""
    mesh = IciMesh.default() if device is None else IciMesh(8, device)
    coll = Collectives(mesh)
    n = mesh.size

    def fabric_step(frames):
        """One transport tick: integrity-transform each rank's frame, push
        it one ring hop, and fold an all-reduce (the ParallelChannel
        merge)."""
        checked = frames.map(lambda f: f + torch.cumsum(f, 0) * 1e-6)
        hopped = coll.ppermute(checked, 1)
        reduced = coll.all_reduce(hopped)
        return hopped.map(
            lambda h: h + reduced.to(h.device) * (1.0 / (1 + n)))

    frames = coll.shard(torch.ones((n, FRAME_LEN), dtype=torch.float32))
    return fabric_step, (frames,)


def fabric_step_reference(frames: torch.Tensor) -> torch.Tensor:
    """The same formula in float64 on the host, for ``(n, len)`` frames."""
    f = frames.detach().to("cpu", torch.float64)
    n = f.shape[0]
    checked = f + torch.cumsum(f, 1) * 1e-6
    hopped = torch.roll(checked, 1, 0)
    return hopped + hopped.sum(0) * (1.0 / (1 + n))


# ---- the dryrun -------------------------------------------------------

class _Launches:
    """This process's ``p2p_copy`` launches: the kernel wrapper's count on
    the card; on the CPU, calls of its plain version (counted through a
    shim installed for the dryrun and removed after it)."""

    def __init__(self, device_type: str):
        import importlib
        self._mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
        self._cpu = device_type != "cuda"
        self._plain = [0]
        self._inner = None
        if self._cpu:
            inner = self._inner = self._mod.p2p_copy_plain
            plain = self._plain

            def counted(src, dst):
                plain[0] += 1
                return inner(src, dst)

            self._mod.p2p_copy_plain = counted

    def count(self) -> int:
        return self._plain[0] if self._cpu else self._mod.p2p_copy.launches

    def close(self) -> None:
        if self._inner is not None:
            self._mod.p2p_copy_plain = self._inner
            self._inner = None


def _step(mesh: IciMesh) -> dict:
    """The fabric step every parallelism axis exercises, at d = 16."""
    n, d = mesh.size, 16
    coll = Collectives(mesh)
    w_tp = coll.shard(torch.ones((n, d, d)))
    grads_dp = coll.shard(torch.ones((n, d, d)))
    seq_sp = coll.shard(torch.ones((n, 4, d)))
    tokens_ep = coll.shard(torch.arange(n * n * d, dtype=torch.float32)
                           .reshape(n, n, d))
    x = coll.replicate(torch.ones(d))
    y = coll.all_reduce(w_tp.map(lambda w: w @ x.to(w.device)))      # tp
    g_sync = coll.all_reduce(grads_dp) / n                           # dp
    s_next = coll.ppermute(seq_sp)                                   # sp
    t_resh = coll.all_to_all(tokens_ep)                              # ep
    w_new = w_tp.map(lambda w: w - 1e-3 * g_sync.to(w.device))
    # tp: the matvec summed over shards is n * d in every element
    torch.testing.assert_close(y.cpu(), torch.full((d,), float(d * n)),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(w_new.stack().cpu(),
                               torch.full((n, d, d), 1.0 - 1e-3))
    assert torch.equal(s_next.stack().cpu(), torch.ones(n, 4, d))
    want = torch.arange(n * n * d, dtype=torch.float32).reshape(n, n, d)
    assert torch.equal(t_resh.stack().cpu(), want.transpose(0, 1)), \
        "all_to_all resharded the tokens wrong"
    return {}


def _dryrun_rpc_stack(mesh: IciMesh, launches: _Launches) -> dict:
    import brpc_tpu_torch.policy  # noqa: F401  (registers protocols)
    from . import rpc
    from .butil import flags
    from .channels.collective_lowering import (CollectiveChannel,
                                               MAP_SHARD, MERGE_SUM)
    from .ici import device_plane
    from .ici.ring import RingStream
    from .proto.echo_pb2 import EchoRequest, EchoResponse

    class EchoService(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = "fab:" + request.message
            if len(cntl.request_attachment):
                cntl.response_attachment.append(cntl.request_attachment)
            done()

    n = mesh.size
    out = {}
    server = rpc.Server()
    server.add_service(EchoService())
    assert server.start("ici://0") == 0, "ici server failed to start"
    ch = rpc.Channel()
    try:
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                      max_retry=0))
        payload = mesh.device_put(torch.arange(2048).to(torch.uint8),
                                  1 % n)
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message="dry"), EchoResponse)
        assert not cntl.failed(), f"ici echo failed: {cntl.error_text}"
        assert resp.message == "fab:dry"
        assert cntl.response_attachment.to_bytes() == \
            bytes(torch.arange(2048).to(torch.uint8).numpy())

        # a ParallelChannel fan-out lowered to one program over the mesh
        cc = CollectiveChannel(mesh)
        cc.register("Shard.MatVec", lambda w, xv: w @ xv.to(w.device),
                    merge=MERGE_SUM, mapping=MAP_SHARD)
        d = 8
        y = cc.call("Shard.MatVec", cc.shard(torch.ones((n, d, d))),
                    cc.replicate(torch.ones(d)))
        torch.testing.assert_close(torch.as_tensor(y).cpu()[:1],
                                   torch.full((1,), float(d * n)),
                                   rtol=1e-5, atol=0)

        # the device plane: a payload crosses the mesh through the plane's
        # copy (p2p_copy on the card), one launch per transfer
        if n >= 2:
            saved = {k: flags.get_flag(k) for k in
                     ("ici_device_plane_host_mesh",
                      "ici_device_plane_threshold")}
            flags.set_flag("ici_device_plane_host_mesh", True)
            flags.set_flag("ici_device_plane_threshold", 4096)
            try:
                plane = device_plane.plane()
                before = plane.stats()["transfers"]
                l0 = launches.count()
                want = torch.arange(64 * 1024).to(torch.uint8)
                dp_payload = mesh.device_put(want, 1)
                cntl = rpc.Controller()
                cntl.request_attachment.append_device_array(dp_payload)
                ch.call_method("EchoService.Echo", cntl,
                               EchoRequest(message="dp"), EchoResponse)
                assert not cntl.failed(), \
                    f"device-plane echo: {cntl.error_text}"
                assert cntl.response_attachment.to_bytes() == \
                    bytes(want.numpy())
                transfers = plane.stats()["transfers"] - before
                moved = launches.count() - l0
                assert transfers > 0, \
                    "payload did not cross through the device plane"
                assert moved == transfers, \
                    (f"p2p_copy launched {moved} times for {transfers} "
                     f"plane transfers")
                out["plane_transfers"] = transfers
                out["plane_launches"] = moved
            finally:
                for k, v in saved.items():
                    flags.set_flag(k, v)

        # RingStream: the credit-windowed chunk pipeline over the ring
        delivered = []
        rs = RingStream(hops=1, window=2, mesh=mesh,
                        on_chunk=lambda c: delivered.append(c))
        coll = Collectives(mesh)
        for i in range(5):
            chunk = coll.shard(torch.full((n, 16), float(i)))
            assert rs.write(chunk, timeout=60), "ring window stalled"
        assert rs.flush(timeout=60), "ring flush timed out"
        assert len(delivered) == 5
    finally:
        ch.close()
        server.stop()
    return out


def _dryrun_collective_fanout(mesh: IciMesh) -> Optional[dict]:
    import brpc_tpu_torch.policy  # noqa: F401
    from . import channels, rpc
    from .butil import flags
    from .ici.route import collective_stats
    from .proto.echo_pb2 import EchoRequest, EchoResponse

    if mesh.size < 4:
        print("dryrun: < 4 mesh devices — collective fan-out leg "
              "SKIPPED (fan-outs keep the per-member RPC loop)", flush=True)
        return None
    n, shard = 4, 128

    class DryFan(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Dry(self, cntl, request, response, done):
            cntl.response_attachment.append(
                cntl.request_attachment.to_bytes())
            done()

    servers, chans = [], []
    try:
        for i in range(n):
            s = rpc.Server()
            s.add_service(DryFan())
            s.register_collective("DryFan.Dry", lambda x: x,
                                  merge=channels.MERGE_GATHER,
                                  mapping=channels.MAP_SHARD)
            assert s.start(f"ici://{i}") == 0
            servers.append(s)
        pc = channels.ParallelChannel()
        mapper = channels.ShardingCallMapper()
        merger = channels.CollectiveMerger(merge=channels.MERGE_GATHER,
                                           dtype="uint8",
                                           shard_shape=(shard,))
        for i in range(n):
            ch = rpc.Channel()
            ch.init(f"ici://{i}", options=rpc.ChannelOptions(
                timeout_ms=60000, max_retry=0))
            pc.add_channel(ch, mapper=mapper, merger=merger)
            chans.append(ch)
        op = torch.arange(n * shard).to(torch.uint8).reshape(n, shard)
        before = collective_stats().get("collective_selected", 0)

        def call():
            cntl = rpc.Controller()
            cntl.fanout_operand = op
            pc.call_method("DryFan.Dry", cntl, EchoRequest(message="d"),
                           EchoResponse())
            assert not cntl.failed(), \
                f"collective fan-out failed: {cntl.error_text}"
            got = torch.as_tensor(cntl.fanout_result).cpu()
            assert torch.equal(got.reshape(n, shard), op), \
                "fan-out result differs from the operand"
            return cntl.fanout_route, bytes(got.numpy())

        route_a, bytes_a = call()
        assert route_a == "collective", "compiled route not selected"
        assert collective_stats().get("collective_selected", 0) \
            == before + 1, "route counter did not move"
        flags.set_flag("ici_fanout_collective", False)
        try:
            route_b, bytes_b = call()
        finally:
            flags.set_flag("ici_fanout_collective", True)
        assert route_b == "rpc", "A/B fallback route not taken"
        assert bytes_a == bytes_b, "collective and per-member loop differ"
    finally:
        for ch in chans:
            ch.close()
        for s in servers:
            s.stop()
    return {"routes": [route_a, route_b]}


def _dryrun_native_door(mesh: IciMesh) -> Optional[dict]:
    import brpc_tpu_torch.policy  # noqa: F401
    from . import rpc
    from .ici import native_plane
    from .proto.echo_pb2 import EchoRequest, EchoResponse

    if not native_plane.available():
        print("dryrun phase 2c SKIP: native core unavailable — the "
              "native dispatch chain needs the native ici listener",
              flush=True)
        return None

    class EchoService(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = "door:" + request.message
            if len(cntl.request_attachment):
                cntl.response_attachment = cntl.request_attachment
            done()

    def leg(native: bool):
        server = rpc.Server(rpc.ServerOptions(usercode_inline=True,
                                              native_ici=native))
        server.add_service(EchoService())
        assert server.start("ici://0") == 0
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(
            timeout_ms=60000, max_retry=0, ici_local_device=0))
        try:
            payload = mesh.device_put(torch.arange(1024).to(torch.uint8), 0)
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("EchoService.Echo", cntl,
                                  EchoRequest(message="m"), EchoResponse)
            assert not cntl.failed(), cntl.error_text
            out = (resp.message, cntl.response_attachment.to_bytes())
            binding = server._native_ici
            requests = binding.requests() if binding is not None else 0
        finally:
            ch.close()
            server.stop()
        return out, requests

    native_out, n_native = leg(True)
    python_out, n_python = leg(False)
    assert n_native >= 1, f"the native listener counted {n_native} requests"
    assert n_python == 0, "the Python-plane leg reached a native listener"
    assert native_out == python_out, "native and Python doors differ"
    assert native_out[1] == bytes(torch.arange(1024).to(torch.uint8)
                                  .numpy())
    assert native_plane.registry().live() == 0
    assert native_plane.att_table_live() == 0
    print(f"dryrun phase 2c (native door): ok (native={n_native} "
          f"python={n_python} byte-exact)", flush=True)
    return {"native_requests": n_native}


def _serving_imports():
    import brpc_tpu_torch.policy  # noqa: F401
    from . import rpc
    from .examples.disagg_serving.model import (KV_DMODEL, KV_LAYERS,
                                                VOCAB, reference_generate,
                                                toy_kv_blocks)
    from .examples.disagg_serving.workers import DecodeService
    from .proto.echo_pb2 import EchoRequest, EchoResponse
    from .serving import BatchSchedulerOptions, KvPoolOptions
    return (rpc, KV_DMODEL, KV_LAYERS, VOCAB, reference_generate,
            toy_kv_blocks, DecodeService, EchoRequest, EchoResponse,
            BatchSchedulerOptions, KvPoolOptions)


def _kv_bytes(toy_kv_blocks, tokens) -> bytes:
    return bytes(toy_kv_blocks(tokens, device="cpu").numpy())


def _dryrun_serving(mesh: IciMesh) -> Optional[dict]:
    (rpc, KV_DMODEL, KV_LAYERS, VOCAB, reference_generate, toy_kv_blocks,
     DecodeService, EchoRequest, EchoResponse, BatchSchedulerOptions,
     KvPoolOptions) = _serving_imports()
    if mesh.size < 2:
        print("dryrun phase 2d SKIP: serving tier wants >= 2 mesh "
              "devices (decode worker + client-side device)", flush=True)
        return None
    bpt = KV_LAYERS * KV_DMODEL
    server = rpc.Server()
    svc = DecodeService(
        1, mesh, pool_options=KvPoolOptions(bytes_per_token=bpt,
                                            num_blocks=128,
                                            block_tokens=16),
        sched_options=BatchSchedulerOptions(vocab=VOCAB, max_batch=8))
    server.add_service(svc)
    assert server.start("ici://1") == 0
    ch = rpc.Channel()
    try:
        ch.init("ici://1", options=rpc.ChannelOptions(timeout_ms=60000))
        specs = {f"d{i}": ([(5 * i + j) % 997 for j in range(24 + 8 * i)],
                           10) for i in range(5)}
        for s, (tokens, _) in specs.items():
            cntl = rpc.Controller()
            cntl.request_attachment.append(_kv_bytes(toy_kv_blocks, tokens))
            ch.call_method("Decode.LoadKv", cntl, EchoRequest(
                message=json.dumps({"session": s, "seq_len": len(tokens),
                                    "last_token": tokens[-1]})),
                EchoResponse)
            assert not cntl.failed(), (s, cntl.error_text)
        results = {}
        lock = threading.Lock()

        def decode(s, steps):
            cntl = rpc.Controller()
            resp = ch.call_method("Decode.Decode", cntl, EchoRequest(
                message=json.dumps({"session": s, "steps": steps})),
                EchoResponse)
            with lock:
                results[s] = (cntl.failed(), cntl.error_text,
                              None if cntl.failed()
                              else json.loads(resp.message)["tokens"])

        threads = [threading.Thread(target=decode, args=(s, steps))
                   for s, (_, steps) in specs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for s, (tokens, steps) in specs.items():
            failed, err, toks = results[s]
            assert not failed, (s, err)
            assert toks == reference_generate(tokens, steps, device="cpu"), s
        d = svc.describe_serving()
        assert d["scheduler"]["steps"] > 0, d
        assert d["scheduler"]["retired"] == len(specs), d
        # >= 1.0: client threads can serialize their admits on a busy
        # host; the batching itself is pinned by the scheduler's tests
        assert d["scheduler"]["batch_occupancy_avg"] >= 1.0, d
        assert d["pool"]["sessions"] == 0, d
    finally:
        ch.close()
        svc.close()
        server.stop()
    print("dryrun phase 2d (serving tier): ok "
          f"({len(specs)} sessions, steps={d['scheduler']['steps']}, "
          f"occupancy={d['scheduler']['batch_occupancy_avg']})", flush=True)
    return {"steps": d["scheduler"]["steps"],
            "occupancy": d["scheduler"]["batch_occupancy_avg"]}


def _dryrun_kv_prefix(mesh: IciMesh) -> Optional[dict]:
    (rpc, KV_DMODEL, KV_LAYERS, _VOCAB, reference_generate, toy_kv_blocks,
     DecodeService, EchoRequest, EchoResponse, _BSO,
     KvPoolOptions) = _serving_imports()
    if mesh.size < 2:
        print("dryrun phase 2e SKIP: kv-prefix tier wants >= 2 mesh "
              "devices (decode worker + client-side device)", flush=True)
        return None
    bpt = KV_LAYERS * KV_DMODEL
    n_sessions, steps = 4, 8
    tokens = [(19 * j) % 997 for j in range(64)]   # 4 full blocks
    want = reference_generate(tokens, steps, device="cpu")
    server = rpc.Server()
    svc = DecodeService(2 % mesh.size, mesh, pool_options=KvPoolOptions(
        bytes_per_token=bpt, num_blocks=64, block_tokens=16))
    server.add_service(svc)
    assert server.start(f"ici://{2 % mesh.size}") == 0
    ch = rpc.Channel()
    try:
        ch.init(f"ici://{2 % mesh.size}",
                options=rpc.ChannelOptions(timeout_ms=60000))
        p0 = svc.describe_serving()["pool"]["prefix"]
        payload = _kv_bytes(toy_kv_blocks, tokens)
        errs = []

        def load(i):
            try:
                cntl = rpc.Controller()
                cntl.request_attachment.append(payload)
                ch.call_method("Decode.LoadKv", cntl, EchoRequest(
                    message=json.dumps({"session": f"px{i}",
                                        "seq_len": len(tokens),
                                        "last_token": tokens[-1]})),
                    EchoResponse)
                if cntl.failed():
                    errs.append((i, cntl.error_text))
            except Exception as e:   # the assertion below names it
                errs.append((i, repr(e)))

        threads = [threading.Thread(target=load, args=(i,))
                   for i in range(n_sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs == [], errs
        p1 = svc.describe_serving()["pool"]["prefix"]
        # every fill ran outside the pool lock (the port's pool has no
        # locked fill, and shares prefixes unconditionally)
        assert p1["unlocked_fills"] - p0["unlocked_fills"] == \
            n_sessions, (p0, p1)
        assert p1["shared_blocks"] == len(tokens) // 16, p1
        assert p1["sharing_ratio"] > 1.0, p1
        for i in range(n_sessions):
            cntl = rpc.Controller()
            resp = ch.call_method("Decode.Decode", cntl, EchoRequest(
                message=json.dumps({"session": f"px{i}", "steps": steps,
                                    "mode": "sync"})), EchoResponse)
            assert not cntl.failed(), (i, cntl.error_text)
            assert json.loads(resp.message)["tokens"] == want, i
        d = svc.describe_serving()["pool"]
        assert d["sessions"] == 0, d
        assert d["prefix"]["shared_blocks"] == 0, d
    finally:
        ch.close()
        svc.close()
        server.stop()
    print("dryrun phase 2e (kv prefix tier): ok "
          f"({n_sessions} sessions on {p1['shared_blocks']} shared blocks, "
          f"sharing_ratio={p1['sharing_ratio']})", flush=True)
    return {"shared_blocks": p1["shared_blocks"],
            "sharing_ratio": p1["sharing_ratio"]}


def _dryrun_kv_migration(mesh: IciMesh) -> Optional[dict]:
    (rpc, KV_DMODEL, KV_LAYERS, _VOCAB, reference_generate, toy_kv_blocks,
     DecodeService, EchoRequest, EchoResponse, _BSO,
     KvPoolOptions) = _serving_imports()
    from .serving.migration import migration_stats
    if mesh.size < 2:
        print("dryrun phase 2f SKIP: live-migration tier wants >= 2 "
              "mesh devices (one decode worker per device)", flush=True)
        return None
    bpt = KV_LAYERS * KV_DMODEL
    steps = 8
    tokens = [(23 * j + 5) % 997 for j in range(64)]   # 4 full blocks
    want = reference_generate(tokens, steps, device="cpu")
    workers, chans = [], []

    def channel(target):
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(timeout_ms=60000))
        chans.append(ch)
        return ch

    try:
        for idx in (0, 1):
            server = rpc.Server()
            svc = DecodeService(idx, mesh, pool_options=KvPoolOptions(
                bytes_per_token=bpt, num_blocks=64, block_tokens=16))
            server.add_service(svc)
            assert server.start(f"ici://{idx}") == 0
            workers.append((server, svc))
        (_, svc_a), (_, svc_b) = workers
        ch = channel("ici://0")
        m0 = migration_stats()
        cntl = rpc.Controller()
        cntl.request_attachment.append(_kv_bytes(toy_kv_blocks, tokens))
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": "mg", "seq_len": len(tokens),
                                "last_token": tokens[-1]})), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        # a decode on A first: the migrated copy carries the same stored
        # KV that already served
        cntl = rpc.Controller()
        resp = ch.call_method("Decode.Decode", cntl, EchoRequest(
            message=json.dumps({"session": "mg", "steps": steps,
                                "mode": "sync", "release": False})),
            EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["tokens"] == want
        # the move: A -> B, the source released only after B committed
        cntl = rpc.Controller()
        resp = ch.call_method("Decode.MigrateOut", cntl, EchoRequest(
            message=json.dumps({"session": "mg", "dest": "ici://1"})),
            EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["migrated"]
        assert svc_a.pool.get("mg") is None           # custody moved
        assert svc_b.pool.get("mg") is not None
        m1 = migration_stats()
        for k in ("migrations_out", "migrations_in", "cutovers"):
            assert m1[k] - m0[k] == 1, (k, m0, m1)
        moved = m1["bytes_moved"] - m0["bytes_moved"]
        assert moved == len(tokens) * bpt, moved
        # the decode on B, through the migrated blocks
        cntl = rpc.Controller()
        resp = channel("ici://1").call_method(
            "Decode.Decode", cntl, EchoRequest(message=json.dumps(
                {"session": "mg", "steps": steps, "mode": "sync"})),
            EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["tokens"] == want
        assert svc_b.describe_serving()["pool"]["sessions"] == 0
    finally:
        for ch in chans:
            ch.close()
        for server, svc in workers:
            svc.close()
            server.stop()
    print("dryrun phase 2f (live kv migration): ok "
          f"({moved} bytes moved, decode bit-exact on the destination, "
          "custody drained)", flush=True)
    return {"bytes_moved": moved}


def _run_child(args, timeout: float = CHILD_TIMEOUT_S) -> dict:
    """Run ``python -m brpc_tpu_torch.graft_entry <args>`` in a fresh
    interpreter and return its ``RESULT`` line (raises on a failure)."""
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.graft_entry", *args],
        cwd=_PKG_ROOT, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(
            f"dryrun child {args} ended rc {proc.returncode}:\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][7:])


def _dryrun_fabric(device: str) -> dict:
    """The three two-process legs in one child (process 0) against one
    fabric peer (process 1)."""
    res = _run_child(["--fabric-child", "--device", device])
    st = res["stress"]
    assert st["errors"] == [], f"fabric stress: {st['errors'][:3]}"
    assert st["mismatched"] == 0, "fabric stress: bytes differ"
    stream = res["stream"]
    assert stream["peer_chunks"] == stream["chunks"] and \
        stream["peer_bad"] == 0, f"fabric stream: {stream}"
    print(f"dryrun phase 3 (fabric stress): ok ({st['calls']} calls, "
          f"{st['threads']} threads; stream of "
          f"{stream['chunks']} chunks verified)", flush=True)
    for name in ("shm_tier", "shm_striped"):
        leg = res[name]
        if leg.get("skip"):
            what = "STRIPED shm" if name == "shm_striped" else "shm bulk-tier"
            print(f"dryrun: /dev/shm unavailable or denied — {what} leg "
                  f"SKIPPED (fabric pairs keep the socket bulk tier)",
                  flush=True)
            continue
        assert leg["errors"] == [] and leg["mismatched"] == 0, leg
        assert leg["shm_bytes"] > 0, f"{name}: nothing rode the shm ring"
        assert leg["stripes"] == leg["want_stripes"], leg
        if leg["want_stripes"] > 1:
            # every stripe carried its share (per-stripe counters exist
            # only for a striped ring)
            assert len(leg["stripe_bytes"]) == leg["want_stripes"] and \
                all(v > 0 for v in leg["stripe_bytes"].values()), \
                f"{name}: a stripe carried nothing: {leg['stripe_bytes']}"
        print(f"dryrun phase 3{'c' if name == 'shm_striped' else 'b'} "
              f"({name}): ok ({leg['calls']} calls, {leg['shm_bytes']} B "
              f"on the ring, stripes {leg['stripe_bytes']})", flush=True)
    return res


def _dryrun_pod_membership(device: str) -> dict:
    from .tools import pod_peer
    res = pod_peer.run_members("chaos", 4, device,
                               ["--attach", POD_ATTACH],
                               timeout=CHILD_TIMEOUT_S, cwd=_PKG_ROOT)
    for pid, (rc, r, text) in enumerate(res):
        if rc != 0 or r is None:
            raise RuntimeError(f"pod member {pid} ended rc {rc}:\n"
                               f"{text[-4000:]}")
    epochs = [r["epoch"] for _, r, _ in res]
    assert all(r["failed"] == 0 for _, r, _ in res), \
        [r["failures"] for _, r, _ in res]
    assert len(set(epochs)) == 1 and epochs[0] == 2 * 4 + 4, epochs
    launches = [r["counts"]["launches"] for _, r, _ in res]
    print(f"dryrun phase 4 (N=4 pod membership): ok (epochs {epochs}, "
          f"calls {[r['calls'] for _, r, _ in res]}, member launches "
          f"{launches})", flush=True)
    return {"epochs": epochs, "member_launches": sum(launches)}


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     cross_process: bool = True) -> dict:
    """See the module docstring."""
    from .butil import flags
    mesh = IciMesh(n_devices, device)
    dtype = mesh.device_type
    prev_default = IciMesh._default
    IciMesh.set_default(mesh)
    saved = {k: flags.get_flag(k) for k in ("ici_device_plane_host_mesh",)}
    if dtype == "cpu":
        # engage the device plane on a host mesh, as the tests do
        flags.set_flag("ici_device_plane_host_mesh", True)
    launches = _Launches(dtype)
    legs = {}

    def leg(name, fn):
        t0 = time.monotonic()
        l0 = launches.count()
        res = fn()
        legs[name] = {"wall_s": time.monotonic() - t0,
                      "launches": launches.count() - l0,
                      **({"skipped": True} if res is None else res)}
        print(f"dryrun leg {name}: {legs[name]['wall_s']:.3f} s, "
              f"{legs[name]['launches']} p2p_copy launches here", flush=True)

    try:
        leg("step", lambda: _step(mesh))
        leg("rpc_stack", lambda: _dryrun_rpc_stack(mesh, launches))
        leg("collective_fanout", lambda: _dryrun_collective_fanout(mesh))
        leg("native_door", lambda: _dryrun_native_door(mesh))
        leg("serving", lambda: _dryrun_serving(mesh))
        leg("kv_prefix", lambda: _dryrun_kv_prefix(mesh))
        leg("kv_migration", lambda: _dryrun_kv_migration(mesh))
        if cross_process:
            dev = "cpu" if dtype == "cpu" else "cuda"
            leg("fabric", lambda: _dryrun_fabric(dev))
            leg("pod_membership", lambda: _dryrun_pod_membership(dev))
    finally:
        launches.close()
        for k, v in saved.items():
            flags.set_flag(k, v)
        IciMesh.set_default(prev_default)
    return legs


# ---- the two-process child ---------------------------------------------

def _fabric_child(device: str, sizes: dict) -> dict:
    """Process 0 of a two-process fabric (the store's host, ranks 4-7)
    against a ``fabric_peer`` it starts (process 1, ranks 0-3,
    ``ici://0``): the stress, stream and shm legs of
    :func:`dryrun_multichip`."""
    import importlib
    from datetime import timedelta
    from torch.distributed import TCPStore
    import brpc_tpu_torch.policy  # noqa: F401
    from . import rpc
    from .butil import flags
    from .butil.iobuf import IOBuf
    from .ici import fabric, route
    from .proto.echo_pb2 import EchoRequest, EchoResponse
    from .rpc.socket import list_sockets
    from .tools import fabric_peer, pod_peer

    mesh = IciMesh(8, device=device)
    IciMesh.set_default(mesh)
    launches = _Launches(mesh.device_type)
    if mesh.device_type == "cpu":
        flags.set_flag("ici_device_plane_host_mesh", True)
    flags.set_flag("ici_device_plane_threshold", fabric_peer.DEVICE_THRESHOLD)
    # both ends run the peer's window (a stream's credit assumes it)
    flags.set_flag("ici_socket_window_bytes", fabric_peer.SOCKET_WINDOW)
    port = pod_peer.free_port()
    coord = f"127.0.0.1:{port}"
    node = fabric.FabricNode.initialize(coord, 2, 0, ranks=range(4, 8),
                                        mesh=mesh)
    kv = TCPStore("127.0.0.1", port, is_master=False,
                  timeout=timedelta(seconds=60))
    peer = subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.tools.fabric_peer", coord,
         "dryrun", "--device", device], cwd=_PKG_ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    chans = []
    out = {}
    dev = mesh.device(4)
    gen = torch.Generator(device=dev).manual_seed(23)

    def channel():
        while chans:                         # one connection at a time
            chans.pop().close()
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                      max_retry=0))
        chans.append(ch)
        return ch

    def call(ch, method, msg="", att=None, host=None):
        cntl = rpc.Controller()
        if att is not None:
            cntl.request_attachment.append_device_array(att)
        if host is not None:
            cntl.request_attachment.append(host)
        resp = ch.call_method(method, cntl, EchoRequest(message=msg),
                              EchoResponse)
        return cntl, resp

    def stats(ch, reset=False):
        cntl, resp = call(ch, "Sink.Stats", "reset" if reset else "")
        if cntl.failed():
            raise RuntimeError(f"Sink.Stats: {cntl.error_text}")
        return json.loads(resp.message)

    def sock():
        return [s for s in list_sockets()
                if isinstance(s, fabric.FabricSocket) and not s.failed
                and not s.is_server_side][-1]

    def fresh(nbytes):
        return mesh.own(torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                      device=dev, generator=gen), 4)

    def pushes(ch, threads, calls, make):
        """``threads`` clients, ``calls`` Sink.Push each with ``make(i)``
        = (device tensor or None, host bytes or None) attached; returns
        (errors, calls whose echo differs)."""
        errs, bad = [], [0]
        lock = threading.Lock()

        def client(t):
            for i in range(calls):
                att, host = make(t * calls + i)
                want = bytes(att.cpu().numpy()) if att is not None else host
                cntl, _ = call(ch, "Sink.Push", "p", att=att, host=host)
                with lock:
                    if cntl.failed():
                        errs.append((cntl.error_code_, cntl.error_text))
                    elif cntl.response_attachment.to_bytes() != want:
                        bad[0] += 1

        ts = [threading.Thread(target=client, args=(t,))
              for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return errs, bad[0]

    try:
        key = "fabric_peer/dryrun"
        deadline = time.monotonic() + 120
        while not kv.check([key]):
            if peer.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"fabric peer did not come up "
                                   f"(rc {peer.poll()})")
            time.sleep(0.05)
        # (1) stress: DEVICE payloads (pulled across as kind 4) and host
        # payloads from concurrent threads, bounced back byte-exact
        ch = channel()
        stats(ch, reset=True)
        l0 = launches.count()
        th, calls = sizes["stress_threads"], sizes["stress_calls"]
        hb = sizes["stress_host_bytes"]

        def stress_payload(i):
            if i % 2:
                return None, bytes([(i + k) % 251 for k in range(251)]) \
                    * (hb // 251)
            return fresh(sizes["stress_device_bytes"]), None

        errs, bad = pushes(ch, th, calls, stress_payload)
        theirs = stats(ch)
        out["stress"] = {"calls": th * calls, "threads": th,
                         "errors": errs[:5], "mismatched": bad,
                         "launches": launches.count() - l0,
                         "peer_launches": theirs["launches"],
                         "peer_received": theirs["received"]}
        # (2) a stream across the process boundary, every chunk verified
        # by the peer in sequence order
        ch = channel()
        stats(ch, reset=True)
        cntl = rpc.Controller()
        st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=8 << 20))
        ch.call_method("Stream.Start", cntl, EchoRequest(message="verify"),
                       EchoResponse)
        if cntl.failed() or not st.wait_connected(10):
            raise RuntimeError(f"stream: {cntl.error_text}")
        n, size = sizes["stream_chunks"], sizes["stream_chunk"]
        for seq in range(n):
            body = b"%08d" % seq + bytes([seq % 251]) * (size - 8)
            if st.write(IOBuf(body), timeout=30) != 0:
                raise RuntimeError(f"stream write {seq} failed")
        deadline = time.monotonic() + 60
        while stats(ch)["stream_bytes"] < n * size:
            if time.monotonic() > deadline:
                raise RuntimeError("stream did not arrive")
            time.sleep(0.01)
        st.close()
        theirs = stats(ch)
        out["stream"] = {"chunks": n, "peer_chunks": theirs["stream_chunks"],
                         "peer_bad": theirs["stream_bad"]}
        # (3) the same-host shm ring: one ring, then four stripes, the
        # route read off this side's byte counters
        shm_ok = bool(node._shm_ok)
        for name, stripes in (("shm_tier", 1), ("shm_striped", 4)):
            if not shm_ok:
                out[name] = {"skip": True}
                continue
            flags.set_flag("ici_fabric_shm", True)
            flags.set_flag("ici_shm_stripes", stripes)
            ch = channel()
            stats(ch, reset=True)
            s = sock()
            shm0 = s.shm_bytes_sent
            rs0 = route.route_stats()
            sb = sizes["shm_bytes"]
            errs, bad = pushes(ch, 1, sizes["shm_calls"], lambda i: (
                None, bytes([(i * 7 + k) % 251 for k in range(251)])
                * (sb // 251)))
            rs1 = route.route_stats()
            d = s.describe_shm() or {}
            out[name] = {
                "calls": sizes["shm_calls"], "errors": errs[:5],
                "mismatched": bad, "shm_bytes": s.shm_bytes_sent - shm0,
                "stripes": d.get("stripes", 0), "want_stripes": stripes,
                "stripe_bytes": {k: v - rs0.get(k, 0)
                                 for k, v in rs1.items()
                                 if k.startswith("shm_stripe_")
                                 and k.endswith("_bytes")
                                 and v != rs0.get(k, 0)}}
        ch = channel()
        call(ch, "Sink.Stop", json.dumps({"grace_s": 0}))
        out["child_launches"] = launches.count()
    finally:
        for ch in chans:
            ch.close()
        try:
            peer.wait(30)
        except subprocess.TimeoutExpired:
            peer.kill()
            peer.wait()
        node.quiesce()
        launches.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--fabric-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.fabric_child:
        import faulthandler
        faulthandler.enable(all_threads=True)
        sizes = FABRIC_SIZES if args.device != "cpu" else FABRIC_SIZES_CPU
        res = _fabric_child(args.device or "cuda", sizes)
        sys.stdout.write("RESULT " + json.dumps(res) + "\n")
        sys.stdout.flush()
        return 0
    t0 = time.monotonic()
    fn, (frames,) = entry(args.device)
    got = fn(frames).stack()
    ref = fabric_step_reference(frames.stack())
    got64 = got.cpu().double()
    torch.testing.assert_close(got64, ref, rtol=1e-5, atol=0)
    out = {"entry": {"shape": list(got.shape), "device": str(got.device),
                     "max_abs_err_vs_float64":
                         (got64 - ref).abs().max().item(),
                     "wall_s": time.monotonic() - t0}}
    print("entry: ok", flush=True)
    out["legs"] = dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}): ok", flush=True)
    # the last line, in one write: what a driving process reads
    sys.stdout.write("RESULT " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
