"""A rank whose owning process died, then served locally: both packages.

A fabric process owns some ranks and exits.  A server then starts in the
surviving process on one of those ranks.  The test asks, on each package,
for a ``Channel`` call to that rank and for
``SocketMap.get_short_socket`` to it.

Both packages route the two apart in the same way:

- a ``Channel`` takes the native ``ici://`` door first when a native
  listener on the rank exists in this process
  (``brpc_tpu/rpc/channel.py:462``, ``brpc_tpu_torch/rpc/channel.py:470``),
  so the call reaches the local server;
- ``SocketMap`` connects through the fabric's ``connect_any``, which
  routes by the rank's owning process (``brpc_tpu/ici/fabric.py:2934``,
  ``brpc_tpu_torch/ici/fabric.py``'s ``connect_any``), so the connect
  goes to the dead process and fails.

Each package's leg runs in fresh interpreters on the CPU.  The JAX leg is
two ``jax.distributed`` processes of two CPU devices each (process 1 owns
ranks 2-3 and exits; the server starts on ``ici://2``); the port's leg is
phase 17's pairing (a ``fabric_peer``, process 1, owns ranks 0-3 and
stops; the server starts on ``ici://1`` in process 0).  The outcomes are
compared: the call succeeds and the short socket fails, on both.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import pytest

from tests.torch_procs import jax_core_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_CHILD = r"""
import os, sys, time, json
sys.path.insert(0, %(repo)r)
sys.path.insert(0, os.path.join(%(repo)r, "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); coord = sys.argv[2]
from brpc_tpu.ici.fabric import FabricNode
node = FabricNode.initialize(coord, num_processes=2, process_id=pid)
kv = node._kv
import brpc_tpu.policy
from brpc_tpu import rpc, ici
from brpc_tpu.butil.endpoint import parse_endpoint
from brpc_tpu.rpc.socket_map import SocketMap
from echo_pb2 import EchoRequest, EchoResponse
mesh = ici.IciMesh(); ici.IciMesh.set_default(mesh)
if pid == 1:
    kv.key_value_set("peer_gone", "1")
    sys.stdout.flush()
    os._exit(0)
kv.blocking_key_value_get("peer_gone", 60000)
time.sleep(1.0)

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "local:" + request.message
        done()

server = rpc.Server()
server.add_service(Echo())
assert server.start("ici://2") == 0
out = {"owner": FabricNode.device_owner(2)}
ch = rpc.Channel()
ch.init("ici://2", options=rpc.ChannelOptions(timeout_ms=5000, max_retry=0))
cntl = rpc.Controller()
resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message="x"),
                      EchoResponse)
out["channel"] = ("failed: " + cntl.error_text) if cntl.failed() \
    else resp.message
try:
    s = SocketMap.instance().get_short_socket(parse_endpoint("ici://2"),
                                              connect_timeout=5.0)
    out["short_socket"] = "ok"
    s.set_failed()
except Exception as e:
    out["short_socket"] = "failed: %%s: %%s" %% (type(e).__name__, e)
sys.stdout.write("RESULT " + json.dumps(out) + "\n")
sys.stdout.flush()
os._exit(0)
"""

_PORT_CHILD = r"""
import os, sys, time, json, subprocess
sys.path.insert(0, %(repo)r)
from datetime import timedelta
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.ici.fabric import FabricNode
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.socket_map import SocketMap
from torch.distributed import TCPStore
coord = sys.argv[1]; port = int(coord.rpartition(":")[2])
flags.set_flag("ici_device_plane_host_mesh", True)
mesh = IciMesh(8, device="cpu"); IciMesh.set_default(mesh)
node = FabricNode.initialize(coord, 2, 0, ranks=range(4, 8), mesh=mesh)
kv = TCPStore("127.0.0.1", port, is_master=False,
              timeout=timedelta(seconds=60))
peer = subprocess.Popen([sys.executable, "-m",
                         "brpc_tpu_torch.tools.fabric_peer", coord, "p",
                         "--device", "cpu"], cwd=%(repo)r,
                        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
kv.wait(["fabric_peer/p"], timedelta(seconds=60))
stop = rpc.Channel()
stop.init("ici://0", options=rpc.ChannelOptions(timeout_ms=10000,
                                                max_retry=0))
c0 = rpc.Controller()
stop.call_method("Sink.Stop", c0, EchoRequest(message="{}"), EchoResponse)
assert not c0.failed(), c0.error_text
stop.close()
assert peer.wait(60) == 0
time.sleep(1.0)

class Echo(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "local:" + request.message
        done()

server = rpc.Server()
server.add_service(Echo())
assert server.start("ici://1") == 0
out = {"owner": node.device_owner(1)}
ch = rpc.Channel()
ch.init("ici://1", options=rpc.ChannelOptions(timeout_ms=5000, max_retry=0))
cntl = rpc.Controller()
resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message="x"),
                      EchoResponse)
out["channel"] = ("failed: " + cntl.error_text) if cntl.failed() \
    else resp.message
try:
    s = SocketMap.instance().get_short_socket(parse_endpoint("ici://1"),
                                              connect_timeout=5.0)
    out["short_socket"] = "ok"
    s.set_failed()
except Exception as e:
    out["short_socket"] = "failed: %%s: %%s" %% (type(e).__name__, e)
sys.stdout.write("RESULT " + json.dumps(out) + "\n")
sys.stdout.flush()
ch.close()
server.stop()
node.quiesce()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _result(out: str) -> dict:
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{out[-4000:]}")


def _run(cmds, env, timeout=90):
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for c, log in zip(cmds, logs)]
    outs = []
    for p, log in zip(procs, logs):
        try:
            p.wait(timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.seek(0)
        outs.append((p.returncode, log.read()))
    return outs


def _jax_leg() -> dict:
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("JAX_NUM_PROCESSES", None)
    script = _JAX_CHILD % {"repo": REPO}
    outs = _run([[sys.executable, "-c", script, str(i), coord]
                 for i in range(2)], env)
    assert outs[0][0] == 0, outs[0][1][-4000:]
    return _result(outs[0][1])


def _port_leg() -> dict:
    coord = f"127.0.0.1:{_free_port()}"
    script = _PORT_CHILD % {"repo": REPO}
    (rc, out), = _run([[sys.executable, "-c", script, coord]],
                      dict(os.environ))
    assert rc == 0, out[-4000:]
    return _result(out)


def _outcome(r: dict) -> tuple:
    return (r["channel"] == "local:x",
            r["short_socket"].startswith("failed"))


def test_a_dead_owners_rank_served_locally_routes_alike_on_both():
    if not jax_core_available():
        pytest.skip("the JAX package's native core does not load here")
    jax_r, port_r = _jax_leg(), _port_leg()
    # the owner recorded for the rank is the dead process on both
    assert jax_r["owner"] == 1 and port_r["owner"] == 1, (jax_r, port_r)
    # the Channel reaches the local server through the native door; the
    # socket map routes by ownership to the dead process and fails
    assert _outcome(jax_r) == (True, True), jax_r
    assert _outcome(port_r) == _outcome(jax_r), (jax_r, port_r)
