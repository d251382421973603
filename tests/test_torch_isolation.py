"""The port stands alone: it loads neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from brpc_tpu_torch.ici.mesh import IciMesh

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ECHO = r"""
import json, sys
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
flags.set_flag("ici_device_plane_host_mesh", True)
flags.set_flag("ici_device_plane_threshold", 1024)

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()

server = rpc.Server(rpc.ServerOptions(usercode_inline=True))
server.add_service(Echo())
server.start("ici://0")
ch = rpc.Channel()
ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000, max_retry=0))
cntl = rpc.Controller()
payload = mesh.device_put(torch.arange(8192).to(torch.uint8), 1)
cntl.request_attachment.append_device_array(payload)
resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message="iso"),
                      EchoResponse)
ok = (not cntl.failed() and resp.message == "iso"
      and cntl.response_attachment.to_bytes() == bytes(payload.numpy()))
ch.close()
server.stop()
print(json.dumps({
    "ok": ok,
    "transfers": device_plane.plane().stats()["transfers"],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_COLLECTIVES = r"""
import json, sys
import torch
from brpc_tpu_torch import channels
from brpc_tpu_torch.ici import pallas_ring, ring, ring_attention
from brpc_tpu_torch.ici.collective import Collectives
from brpc_tpu_torch.ici.mesh import IciMesh

mesh = IciMesh(ranks=4, device="cpu")
coll = Collectives(mesh)
x = coll.shard(torch.arange(12, dtype=torch.float32).reshape(4, 3))
total = torch.arange(12, dtype=torch.float32).reshape(4, 3).sum(0)
ch = channels.CollectiveChannel(mesh)
ch.register("Sum", lambda row: row, merge=channels.MERGE_SUM)
q = coll.shard(torch.randn(4, 2, 4, 8))
ok = (torch.equal(coll.all_reduce(x), total)
      and torch.equal(pallas_ring.ring_all_reduce(x).stack()[0], total)
      and torch.equal(ring.ring_all_reduce(x).stack()[1], total)
      and pallas_ring.ring_all_gather(x).shape == (4, 4, 3)
      and torch.equal(ch.call("Sum", x), total)
      and ring_attention.ring_attention(q, q, q).shape == q.shape
      and ring_attention.ulysses_attention(q, q, q).shape == q.shape)
print(json.dumps({
    "ok": ok,
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SERVING = r"""
import json, sys
import brpc_tpu_torch.policy
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.examples.disagg_serving import demo

rc = demo.main(["--device", "cpu"])
print(json.dumps({
    "ok": rc == 0,
    "transfers": device_plane.plane().stats()["transfers"],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE4 = r"""
import json, sys
import numpy as np
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane, plane_health, route
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import admission, request_context
from brpc_tpu_torch.serving import (KvPoolOptions, LoadAwareRouter,
                                    PagedKvPool, migration, migrate_out)
from brpc_tpu_torch.examples.disagg_serving.workers import (
    close_services, start_decode_worker)

mesh = IciMesh(ranks=4, device="cpu")
IciMesh.set_default(mesh)
flags.set_flag("ici_device_plane_host_mesh", True)
flags.set_flag("ici_device_plane_threshold", 1024)
rows = torch.arange(64 * 32, dtype=torch.int64).remainder(251).to(
    torch.uint8).view(64, 32)
pool = PagedKvPool(KvPoolOptions(bytes_per_token=32, num_blocks=4,
                                 block_tokens=16, host_blocks=4,
                                 use_timers=False), device="cpu")
pool.load("a", rows, last_token=1)
spilled = pool.spill("a")
restored = torch.equal(pool.materialize("a"), rows)
pool.close()
a, b = start_decode_worker("ici://1"), start_decode_worker("ici://2")
svc = next(iter(a.services().values()))
svc.pool.load("m", torch.zeros(40, svc.pool.options.bytes_per_token,
                               dtype=torch.uint8), last_token=0)
ch = rpc.Channel()
ch.init("ici://1", options=rpc.ChannelOptions(timeout_ms=30000, max_retry=0))
cntl = rpc.Controller()
ch.call_method("Decode.MigrateOut", cntl, EchoRequest(
    message=json.dumps({"session": "m", "dest": "ici://2"})), EchoResponse)
ch.close()
moved = not cntl.failed() and svc.pool.get("m") is None
close_services(a, b)
router = LoadAwareRouter(["ici://1"])
router.bind_session("m", "ici://2")
router.close()
print(json.dumps({
    "ok": spilled and restored and moved,
    "transfers": device_plane.plane().stats()["transfers"],
    "migrations": migration.migration_stats()["migrations_out"],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE5 = r"""
import json, sys, threading, time
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import bvar, rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import limiters
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import (circuit_breaker, health_check, lameduck,
                                method_status, usercode_pool)
from brpc_tpu_torch.serving import AutoscalerOptions, LoadThresholdAutoscaler

mesh = IciMesh(ranks=4, device="cpu")
IciMesh.set_default(mesh)
flags.set_flag("ici_device_plane_host_mesh", True)
flags.set_flag("ici_device_plane_threshold", 1024)
gate = threading.Event()

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        if request.message == "block":
            gate.wait(10)
        cntl.response_attachment.append(cntl.request_attachment)
        done()

# the Python plane: the lame-duck GOODBYE rides its socket
server = rpc.Server(rpc.ServerOptions(
    max_concurrency=1, usercode_in_pthread=True, usercode_backup_threads=2,
    admission=rpc.AdmissionOptions(max_queue_ms=10), native_ici=False))
server.add_service(Echo())
server.start("ici://2")
ch = rpc.Channel()
ch.init("ici://2", options=rpc.ChannelOptions(timeout_ms=30000, max_retry=0))
blocker = rpc.Controller()
ch.call_method("Echo.Echo", blocker, EchoRequest(message="block"),
               EchoResponse, done=lambda c: None)
while server.inflight_requests() == 0:
    time.sleep(0.001)
shed = rpc.Controller()
shed.priority = 3
shed.request_attachment.append_device_array(
    mesh.own(torch.ones(4096, dtype=torch.uint8), 1))
ch.call_method("Echo.Echo", shed, EchoRequest(message="x"), EchoResponse)
gate.set()
server.stop(2.0)
drained = lameduck.is_draining(parse_endpoint("ici://2"))
ch.close()
pool = usercode_pool.UsercodePool(kind="auto", workers=1)
pool.register("M.h", "def handle(b):\n    return b[::-1]\n")
iso = pool.call_isolated("M.h", b"abc") == b"cba"
pool.shutdown()
lim = limiters.AutoConcurrencyLimiter()
ms = method_status.MethodStatus("M.h", lim)
rec = bvar.LatencyRecorder()
rec << 5
scaler = LoadThresholdAutoscaler(lambda: 0.0, lambda: 2, lambda: True,
                                 lambda: True,
                                 options=AutoscalerOptions(samples_to_scale=1))
down = scaler.tick(now=0.0) == "down"
health_check.start_health_check(parse_endpoint("ici://2")).cancel()
print(json.dumps({
    "ok": (shed.error_code_ == rpc.errors.ELIMIT and shed.retry_after_ms > 0
           and drained and iso and down and ms.on_requested()
           and rec.count() == 1
           and not circuit_breaker.BreakerRegistry.instance().breaker(
               parse_endpoint("ici://2")).is_isolated()),
    "transfers": device_plane.plane().stats()["transfers"],
    "active": device_plane.plane().active_transfers(),
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE6 = r"""
import json, sys
import brpc_tpu_torch.policy
from brpc_tpu_torch.examples import (dynamic_partition_echo, parallel_echo,
                                     partition_echo, selective_echo,
                                     streaming_echo)
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.policy import load_balancers, naming

rcs = [m.main(["--device", "cpu"]) for m in (
    streaming_echo, parallel_echo, partition_echo, selective_echo,
    dynamic_partition_echo)]
print(json.dumps({
    "ok": rcs == [0] * 5 and len(load_balancers.list_load_balancers()) == 9
          and len(naming.create_naming_service("mesh://").get_servers()) == 8,
    "transfers": device_plane.plane().stats()["transfers"],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE7 = r"""
import json, sys
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import bvar, channels, rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.examples import allreduce_performance, param_server
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import span
from brpc_tpu_torch.rpc.builtin.rpc_service import JsonMsg

rcs = [param_server.main(["--device", "cpu"]),
       allreduce_performance.main(["--device", "cpu", "--size-mb", "1"])]
mesh = IciMesh.default()
flags.set_flag("rpcz_enabled", True)

class Fan(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Scale(self, cntl, request, response, done):
        done()

servers = []
for d in range(4):
    s = rpc.Server()
    s.add_service(Fan())
    s.register_collective("Fan.Scale", lambda x: x * 2.0)
    s.start(f"ici://{d}")
    servers.append(s)
pc = channels.ParallelChannel()
merger = channels.CollectiveMerger("gather", "float32", (16,))
chans = []
for d in range(4):
    ch = rpc.Channel()
    ch.init(f"ici://{d}")
    pc.add_channel(ch, mapper=channels.ShardingCallMapper(), merger=merger)
    chans.append(ch)
cntl = rpc.Controller()
cntl.fanout_operand = channels.shard_operand(range(4), torch.ones(4, 16))
pc.call_method("Fan.Scale", cntl, EchoRequest(message="x"), EchoResponse())
c2 = rpc.Controller()
page = chans[0].call_method("brpc_tpu.Builtin.Call", c2,
                            JsonMsg(page="ici"), JsonMsg)
ok = (rcs == [0, 0] and not cntl.failed()
      and cntl.fanout_route == "collective"
      and torch.equal(cntl.fanout_result, torch.full((4, 16), 2.0))
      and not c2.failed() and page["status"] == 200
      and "collective_fanout" in json.loads(page["body"])
      and len(span.find_trace(c2.trace_id)) >= 1
      and "tpu_std_server_handler_count" in bvar.list_exposed())
for ch in chans:
    ch.close()
for s in servers:
    s.stop()
print(json.dumps({
    "ok": ok,
    "transfers": device_plane.plane().stats()["transfers"],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE8 = r"""
import io, json, sys, tempfile
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.examples import (backup_request, cancel_rpc,
                                     session_data_and_thread_local)
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import fault_injection, profiler, rpc_dump
from brpc_tpu_torch.rpc.socket_map import SocketMap
from brpc_tpu_torch.tools import rpc_replay

rcs = [m.main(["--device", "cpu"]) for m in (
    backup_request, cancel_rpc, session_data_and_thread_local)]
mesh = IciMesh.default()

class Echo(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()

# the Python plane: injected drops, timeout hedging, pooled sockets and
# rpc_dump are its features
server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                      native_ici=False))
server.add_service(Echo())
server.register_isolated("Iso.Rev",
                         "def handle(p):\n    return p[::-1]\n")
server.start("ici://3")
ch = rpc.Channel()
ch.init("ici://3", options=rpc.ChannelOptions(
    connection_type="pooled", timeout_ms=3000, max_retry=9,
    retry_on_timeout=True))
d = tempfile.mkdtemp()
flags.set_flag("rpc_dump_dir", d)
flags.set_flag("rpc_dump", True)
answered = 0
with fault_injection.inject(fault_injection.FaultInjector(
        drop_ratio=0.3, seed=4)) as inj:
    for i in range(6):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(
            mesh.device_put(torch.full((8192,), i, dtype=torch.uint8), 1))
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message=str(i)), EchoResponse)
        answered += (not cntl.failed() and resp.message == str(i))
flags.set_flag("rpc_dump", False)
cntl = rpc.Controller()
iso = ch.call_method("Iso.Rev", cntl, b"abc")
pooled = SocketMap.instance().stats().get(parse_endpoint("ici://3"), 0)
replayed = rpc_replay.run_replay("ici://3", d, out=io.StringIO())
ch.close()
server.stop()
ok = (rcs == [0, 0, 0] and answered == 6 and inj.injected["drop"] > 0
      and iso == b"cba" and pooled >= 1 and replayed["ok"] >= 6
      and "function calls" in profiler.profile_for(0.01, top=3))
print(json.dumps({
    "ok": ok,
    "active": device_plane.plane().active_transfers(),
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE9 = r"""
import json, os, sys
opened = []

def _audit(event, args):
    if event == "open" and args and isinstance(args[0], (str, bytes)):
        opened.append(os.fsdecode(args[0]))
    elif event == "ctypes.dlopen" and args and args[0]:
        opened.append(os.fsdecode(args[0]))

sys.addaudithook(_audit)
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags, native
from brpc_tpu_torch.ici import device_plane, native_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import loopback

mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
flags.set_flag("ici_device_plane_host_mesh", True)
flags.set_flag("ici_device_plane_threshold", 1024)

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()

ok = True
for target in ("ici://0", "mem://iso9"):
    server = rpc.Server()
    server.add_service(Echo())
    server.start(target)
    ch = rpc.Channel()
    ch.init(target, options=rpc.ChannelOptions(timeout_ms=30000,
                                               max_retry=0))
    cntl = rpc.Controller()
    payload = mesh.device_put(torch.arange(4096).to(torch.uint8), 1)
    cntl.request_attachment.append_device_array(payload)
    resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message="n"),
                          EchoResponse)
    ok = ok and (not cntl.failed() and resp.message == "n"
                 and cntl.response_attachment.to_bytes()
                 == bytes(payload.numpy()))
    if target.startswith("ici"):
        ok = ok and server._native_ici.requests() == 1
    ch.close()
    server.stop()
repo = os.path.dirname(os.path.dirname(os.path.abspath(
    native_plane.__file__)))
native_dir = os.path.join(repo, "native") + os.sep
print(json.dumps({
    "ok": ok,
    "loopback_calls": loopback.calls,
    "transfers": device_plane.plane().stats()["transfers"],
    "live": native_plane.registry().live(),
    "under_native": sorted({p for p in opened
                            if os.path.abspath(p).startswith(native_dir)}),
    "core": [p for p in opened if "libici_native" in p],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE10 = r"""
import json, os, socket, sys
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane, fabric, ipc_pull
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
flags.set_flag("ici_device_plane_host_mesh", True)

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        cntl.response_attachment.append(cntl.request_attachment)
        done()

# TCP, with the idle reaper and the internal port
tcp = rpc.Server(rpc.ServerOptions(idle_timeout_s=5, internal_port=0))
tcp.add_service(Echo())
tcp.start("127.0.0.1:0")
ch = rpc.Channel()
ch.init(f"127.0.0.1:{tcp.listen_port}",
        options=rpc.ChannelOptions(timeout_ms=10000))
cntl = rpc.Controller()
payload = mesh.device_put(torch.arange(8192).to(torch.uint8), 1)
cntl.request_attachment.append_device_array(payload)
resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message="tcp"),
                      EchoResponse)
ok = (not cntl.failed()
      and cntl.response_attachment.to_bytes() == bytes(payload.numpy()))
ch.close()
tcp.stop()
# a one-process fabric: its store, its listener, an owned rank in process
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
node = fabric.FabricNode.initialize(f"127.0.0.1:{port}", 1, 0, mesh=mesh)
srv = rpc.Server(rpc.ServerOptions(native_ici=False))
srv.add_service(Echo())
srv.start("ici://0")
ch = rpc.Channel()
ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=10000))
cntl = rpc.Controller()
cntl.request_attachment.append_device_array(payload)
ch.call_method("Echo.Echo", cntl, EchoRequest(message="ici"), EchoResponse)
ok = ok and not cntl.failed() and node.ping(0)
ch.close()
srv.stop()
node.quiesce()
print(json.dumps({
    "ok": ok,
    "ranks": node.devices,
    "segments": ipc_pull.segments_on_disk(os.getpid()),
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE11 = r"""
import json, os, socket, sys
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import clock, fabric, ipc_pull
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.ici.pod import Pod
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.builtin import pod_scope
from brpc_tpu_torch.tools import pod_peer

mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
flags.set_flag("ici_device_plane_host_mesh", True)
flags.set_flag("rpcz_enabled", True)

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()

# a one-process pod: join, serve, resolve pod://, a trace query of pod
# scope, a drain, leave
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
node = fabric.FabricNode.initialize(f"127.0.0.1:{port}", 1, 0, mesh=mesh)
pod = Pod.join("iso")
srv = rpc.Server(rpc.ServerOptions(native_ici=False))
srv.add_service(Echo())
srv.start("ici://3")
pod.wait_epoch(2, timeout=10)     # the watch's view holds the advertise
ch = rpc.Channel()
ch.init("pod://iso", "rr", options=rpc.ChannelOptions(timeout_ms=10000))
cntl = rpc.Controller()
ch.call_method("Echo.Echo", cntl, EchoRequest(message="pod"), EchoResponse)
_, body = srv._builtin.dispatch("rpcz", {"trace_id": "%x" % cntl.trace_id})
tree = json.loads(body)["tree"]
ok = (not cntl.failed() and pod.epoch(refresh=True) == 2
      and {n["side"] for n in tree} == {"client"} and tree[0]["children"])
ch.close()
srv.stop(0.5)
epoch = pod.epoch(refresh=True)
pod.leave()
pod_scope.close_channels_for_test()
node.quiesce()
print(json.dumps({
    "ok": ok,
    "epoch": epoch,
    "segments": ipc_pull.segments_on_disk(os.getpid()),
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_SLICE14 = r"""
import json, os, sys
opened = []

def _audit(event, args):
    if event == "open" and args and isinstance(args[0], (str, bytes)):
        opened.append(os.fsdecode(args[0]))
    elif event == "ctypes.dlopen" and args and args[0]:
        opened.append(os.fsdecode(args[0]))

sys.addaudithook(_audit)
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import native
from brpc_tpu_torch.ici import fabric, route
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.native_fabric import (NativeChannel,
                                              NativePooledChannel,
                                              NativeServer)
from brpc_tpu_torch.serving import kv_source

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()

server = NativeServer()
server.add_service(Echo())
server.register_native_echo("Raw.Echo")
port = server.start(0)
ch = NativeChannel()
ch.init(f"127.0.0.1:{port}")
ok = True
for method in ("Echo.Echo", "Raw.Echo"):
    cntl = rpc.Controller()
    resp = ch.call_method(method, cntl, EchoRequest(message="t"),
                          EchoResponse)
    ok = ok and not cntl.failed() and resp.message == "t"
fut = ch.call_method_async("Echo.Echo", rpc.Controller(),
                           EchoRequest(message="a"), EchoResponse)
ok = ok and fut.wait(10) and fut.response.message == "a"
ch.close()
server.stop()
repo = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
native_dir = os.path.join(repo, "native") + os.sep
print(json.dumps({
    "ok": ok,
    "p50": native.native_rpc_echo_p50_us(iters=50, payload=64) > 0,
    "xfer_row": route.XFER,
    "kv_labels": [kv_source.ADOPTED, kv_source.SCATTERED,
                  kv_source.MATERIALIZED],
    "under_native": sorted({p for p in opened
                            if os.path.abspath(p).startswith(native_dir)}),
    "core": [p for p in opened if "libici_native" in p],
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


_EVERY_MODULE = r"""
import importlib, json, pkgutil, sys
import brpc_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    brpc_tpu_torch.__path__, "brpc_tpu_torch."))
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "ok": True,
    "modules": names,
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "brpc_tpu": sorted(m for m in sys.modules
                       if m == "brpc_tpu" or m.startswith("brpc_tpu.")),
}))
"""


def _run_alone(script: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_echo_loads_no_jax_and_no_jax_package():
    out = _run_alone(_ECHO)
    assert out["ok"]
    assert out["transfers"] == 2          # request and response legs
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_port_collectives_load_no_jax_and_no_jax_package():
    out = _run_alone(_COLLECTIVES)
    assert out["ok"]
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_port_serving_stack_loads_no_jax_and_no_jax_package():
    out = _run_alone(_SERVING)
    assert out["ok"]
    assert out["transfers"] == 4          # one KV handoff per Generate
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_port_tiers_migration_and_context_load_no_jax():
    """The host tier, migration over the plane, plane health, router
    affinity, the request context and the shed backoff, driven alone."""
    out = _run_alone(_SLICE4)
    assert out["ok"]
    assert out["transfers"] == 1          # the one MigrateIn
    assert out["migrations"] == 1
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_port_admission_drain_pool_and_autoscaler_load_no_jax():
    """Slice 5 driven alone: an overloaded ici:// server sheds a request
    whose attachment rode the plane, a lame-duck stop sends GOODBYE, the
    usercode pool runs an isolated handler, the limiter, method status,
    latency recorder, breaker, health check and autoscaler all run."""
    out = _run_alone(_SLICE5)
    assert out["ok"]
    assert out["transfers"] == 1          # the shed request's attachment
    assert out["active"] == 0
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_port_streaming_and_combo_channels_load_no_jax():
    """Slice 6 driven alone: the five examples on a CPU mesh (a stream of
    DEVICE chunks echoed both ways, a sharded fan-out, partition,
    selective and dynamic-partition channels over list:// urls), the
    balancers and the mesh:// naming service."""
    out = _run_alone(_SLICE6)
    assert out["ok"]
    # 16 chunks each way, then 4 shards each way
    assert out["transfers"] == 2 * 16 + 2 * 4
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_port_fanout_and_observability_load_no_jax():
    """Slice 7 driven alone: the two examples on a CPU mesh, a compiled
    fan-out over four ici:// servers, a builtin page over RPC with rpcz
    on, and the bvar registry; among the package's modules, this slice's
    own."""
    out = _run_alone(_SLICE7)
    assert out["ok"]
    assert out["transfers"] == 0          # nothing crossed the plane
    assert out["jax"] == []
    assert out["brpc_tpu"] == []
    mods = _run_alone(_EVERY_MODULE)["modules"]
    for name in ("brpc_tpu_torch.channels.collective_fanout",
                 "brpc_tpu_torch.rpc.fault_injection",
                 "brpc_tpu_torch.rpc.span",
                 "brpc_tpu_torch.rpc.builtin.services",
                 "brpc_tpu_torch.rpc.builtin.rpc_service",
                 "brpc_tpu_torch.bvar.variable",
                 "brpc_tpu_torch.bvar.reducer",
                 "brpc_tpu_torch.bvar.window",
                 "brpc_tpu_torch.bvar.latency_recorder",
                 "brpc_tpu_torch.bvar.multi_dimension",
                 "brpc_tpu_torch.bvar.collector",
                 "brpc_tpu_torch.bvar.default_variables",
                 "brpc_tpu_torch.examples.param_server",
                 "brpc_tpu_torch.examples.allreduce_performance"):
        assert name in mods, name


def test_every_port_module_imports_without_jax():
    """Every module of the package, this slice's included, imports with
    neither JAX nor the JAX package loaded."""
    out = _run_alone(_EVERY_MODULE)
    for name in ("brpc_tpu_torch.policy.limiters",
                 "brpc_tpu_torch.rpc.method_status",
                 "brpc_tpu_torch.rpc.admission",
                 "brpc_tpu_torch.rpc.usercode_pool",
                 "brpc_tpu_torch.rpc.lameduck",
                 "brpc_tpu_torch.rpc.circuit_breaker",
                 "brpc_tpu_torch.rpc.health_check",
                 "brpc_tpu_torch.serving.autoscaler",
                 "brpc_tpu_torch.bthread.execution_queue",
                 "brpc_tpu_torch.rpc.stream",
                 "brpc_tpu_torch.rpc.progressive",
                 "brpc_tpu_torch.butil.misc",
                 "brpc_tpu_torch.policy.naming",
                 "brpc_tpu_torch.channels.parallel_channel",
                 "brpc_tpu_torch.channels.partition_channel",
                 "brpc_tpu_torch.channels.selective_channel",
                 "brpc_tpu_torch.tools.rpc_press",
                 "brpc_tpu_torch.tools.rpc_view",
                 "brpc_tpu_torch.tools.parallel_http",
                 *(f"brpc_tpu_torch.examples.{name}" for name in (
                     "echo_client_server", "asynchronous_echo",
                     "multi_threaded_echo", "multi_threaded_echo_fns",
                     "cascade_echo", "auto_concurrency_limiter",
                     "ici_echo", "http_server", "grpc_echo",
                     "grpc_interop", "redis_kv", "memcache_client",
                     "mongo_service", "thrift_echo", "nshead_extension",
                     "rtmp_relay"))):
        assert name in out["modules"], name
    assert out["jax"] == []
    assert out["brpc_tpu"] == []


def test_serving_entry_points_default_to_the_card():
    """The pool and the toy model ask for CUDA unless given the CPU."""
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.serving import KvPoolOptions, PagedKvPool
    opts = KvPoolOptions(bytes_per_token=8, num_blocks=2)
    if torch.cuda.is_available():
        assert PagedKvPool(opts).device.type == "cuda"
        assert model.toy_kv_blocks([1, 2]).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PagedKvPool(opts)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.toy_kv_blocks([1, 2])
    assert PagedKvPool(opts, device="cpu").device.type == "cpu"


def test_default_mesh_is_the_card():
    """``IciMesh()`` with no device asks for CUDA: without a card it
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert IciMesh().device_type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            IciMesh()
    assert IciMesh(ranks=2, device="cpu").device_type == "cpu"
    with pytest.raises(ValueError):
        IciMesh(ranks=2, device="meta")


def test_port_call_features_dump_and_profiler_load_no_jax():
    """Slice 8 driven alone: the three examples on a CPU mesh, seeded
    drops hedged on a pooled ici:// channel with DEVICE attachments and
    rpc_dump on, an isolated handler, the replay of the dump and the
    profiler; among the package's modules, this slice's own."""
    out = _run_alone(_SLICE8)
    assert out["ok"]
    assert out["active"] == 0
    assert out["jax"] == []
    assert out["brpc_tpu"] == []
    mods = _run_alone(_EVERY_MODULE)["modules"]
    for name in ("brpc_tpu_torch.rpc.rpc_dump",
                 "brpc_tpu_torch.rpc.profiler",
                 "brpc_tpu_torch.tools.rpc_replay",
                 "brpc_tpu_torch.examples.backup_request",
                 "brpc_tpu_torch.examples.cancel_rpc",
                 "brpc_tpu_torch.examples.session_data_and_thread_local"):
        assert name in mods, name


def test_port_native_door_and_loopback_load_no_jax_and_no_native_dir():
    """Slice 9 driven alone: a DEVICE echo through the native door on
    ici:// (its core built from the package's own sources) and one through
    the mem:// loopback plane.  Neither JAX, the JAX package nor any path
    under the reference's native/ directory is loaded or opened."""
    out = _run_alone(_SLICE9)
    assert out["ok"]
    assert out["loopback_calls"] == 1
    assert out["transfers"] == 2          # the native echo's two legs
    assert out["live"] == 0
    assert out["under_native"] == []
    assert out["core"] and all("brpc_tpu_torch" in p for p in out["core"])
    assert out["jax"] == []
    assert out["brpc_tpu"] == []
    mods = _run_alone(_EVERY_MODULE)["modules"]
    for name in ("brpc_tpu_torch.ici.native_plane",
                 "brpc_tpu_torch.butil.native",
                 "brpc_tpu_torch.rpc.loopback"):
        assert name in mods, name


def test_port_tcp_and_fabric_load_no_jax():
    """Slice 10 driven alone: a TCP echo of a DEVICE attachment (host bytes
    on the wire) with the reaper and the internal port, then a one-process
    fabric (store, listener, PING) serving an owned rank in process.  The
    two-process legs check their children the same way
    (``tests/test_torch_fabric.py``)."""
    out = _run_alone(_SLICE10)
    assert out["ok"]
    assert out["ranks"] == list(range(8))
    assert out["segments"] == []
    assert out["jax"] == []
    assert out["brpc_tpu"] == []
    mods = _run_alone(_EVERY_MODULE)["modules"]
    for name in ("brpc_tpu_torch.rpc.event_dispatcher",
                 "brpc_tpu_torch.rpc.tcp_transport",
                 "brpc_tpu_torch.ici.fabric",
                 "brpc_tpu_torch.ici.ipc_pull",
                 "brpc_tpu_torch.tools.fabric_peer"):
        assert name in mods, name


def test_port_pod_loads_no_jax():
    """Slice 11 driven alone: a one-process pod (join, an ici:// server
    advertised, a call through ``pod://``, a pod-scope trace query, a
    drain, leave); the many-process legs check their children the same
    way (``tests/test_torch_pod.py``).  Among the package's modules, this
    slice's own."""
    out = _run_alone(_SLICE11)
    assert out["ok"]
    assert out["epoch"] == 4        # join, advertise, drain mark, withdraw
    assert out["segments"] == []
    assert out["jax"] == []
    assert out["brpc_tpu"] == []
    mods = _run_alone(_EVERY_MODULE)["modules"]
    for name in ("brpc_tpu_torch.ici.pod",
                 "brpc_tpu_torch.ici.clock",
                 "brpc_tpu_torch.rpc.builtin.pod_scope",
                 "brpc_tpu_torch.tools.pod_peer"):
        assert name in mods, name


def test_port_native_tcp_kv_routes_and_kind1_load_no_jax():
    """Slice 14 driven alone: a NativeServer (a Python service and a
    native echo) called through a NativeChannel, sync and async, and a
    bench entry, all on the port's own core; the KV loader and the fabric
    with its kind-1 row imported.  Neither JAX, the JAX package nor any
    path under the reference's native/ directory is loaded or opened."""
    out = _run_alone(_SLICE14)
    assert out["ok"] and out["p50"]
    assert out["xfer_row"] == "xfer"
    assert out["under_native"] == []
    assert out["core"] and all("brpc_tpu_torch" in p for p in out["core"])
    assert out["jax"] == []
    assert out["brpc_tpu"] == []
    mods = _run_alone(_EVERY_MODULE)["modules"]
    for name in ("brpc_tpu_torch.rpc.native_fabric",
                 "brpc_tpu_torch.serving.kv_source",
                 "brpc_tpu_torch.examples.native_echo",
                 "brpc_tpu_torch.examples.native_async_pool"):
        assert name in mods, name
