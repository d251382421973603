"""Run a scenario of the port in several fresh interpreters on the CPU.

``run_procs(body, n)`` starts ``n`` copies of :data:`PRELUDE` + ``body``
at once, as processes ``0..n-1`` of one fabric (process 0 hosts the
``TCPStore`` on a free port of ``127.0.0.1``), and returns each one's
``(exit code, RESULT dict or None, output)``.  The prelude gives the
body: ``pid``, ``NPROC``, ``mesh`` (8 CPU ranks, the device plane
engaged), ``node`` (ranks ``2·pid`` and ``2·pid+1``), a store client of
its own with ``put``/``get``/``barrier``, ``fabric_socks()``,
``foreign()`` (modules of JAX or of the JAX package loaded: none may be),
``result(dict)`` and ``finish()``, which holds process 0, the store's
host, until every other process is done with the store.  Children load
no JAX and nothing of the JAX package.

``jax_core_available()`` answers whether the JAX package's native core
loads, waiting out a build that another process is making.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import os, sys, threading, time, json
sys.path.insert(0, %(repo)r)
from datetime import timedelta
pid = int(sys.argv[1]); coord = sys.argv[2]; NPROC = int(sys.argv[3])
import numpy as np
import torch
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc, channels
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import route
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.ici.fabric import FabricNode, FabricSocket
from brpc_tpu_torch.rpc.socket import list_sockets
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.tools.fabric_peer import _exit_with_parent
_exit_with_parent()
flags.set_flag("ici_device_plane_host_mesh", True)
mesh = IciMesh(8, device="cpu"); IciMesh.set_default(mesh)
node = FabricNode.initialize(coord, NPROC, pid, ranks=[2 * pid, 2 * pid + 1],
                             mesh=mesh)
from torch.distributed import TCPStore
_host, _, _port = coord.rpartition(":")
kv = TCPStore(_host, int(_port), is_master=False,
              timeout=timedelta(seconds=120))

def put(k, v):
    kv.set(k, json.dumps(v))

def get(k, t=120):
    kv.wait([k], timedelta(seconds=t))
    return json.loads(kv.get(k))

def barrier(name, t=120):
    put(name + "/" + str(pid), 1)
    for q in range(NPROC):
        get(name + "/" + str(q), t)

def fabric_socks():
    return [s for s in list_sockets() if isinstance(s, FabricSocket)]

def foreign():
    return sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                  or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))

def result(d):
    # one write: another thread's log line (stderr, the same file) cannot
    # land between the line and its newline
    sys.stdout.write("RESULT " + json.dumps(d) + "\n")
    sys.stdout.flush()

def finish():
    if pid:
        put("bye/" + str(pid), 1)
    else:
        for q in range(1, NPROC):
            get("bye/" + str(q))
"""


def free_coord() -> str:
    from brpc_tpu_torch.tools.pod_peer import free_port
    return f"127.0.0.1:{free_port()}"


def run_procs(body: str, n: int, timeout: float = 120.0) -> list:
    """Start ``n`` processes of ``PRELUDE + body`` together; returns
    ``[(rc, result or None, output), ...]``.  A process still running at
    ``timeout`` is killed."""
    coord = free_coord()
    script = PRELUDE % {"repo": REPO} + body
    procs = []
    for pid in range(n):
        log = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", script, str(pid), coord, str(n)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    out = []
    for proc, log in procs:
        try:
            proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        out.append((proc.returncode,
                    json.loads(lines[-1][7:]) if lines else None, text))
    return out


def ok(res, pids=None) -> list:
    """The RESULT dicts of ``res``, asserting the processes ``pids``
    (default all) exited 0 with one; the others' outputs shown on a
    failure."""
    pids = range(len(res)) if pids is None else pids
    bad = [p for p in pids if res[p][0] != 0 or res[p][1] is None]
    assert not bad, "\n".join(
        f"--- process {p} rc {rc} ---\n{text[-5000:]}"
        for p, (rc, _r, text) in enumerate(res))
    return [r for _rc, r, _t in res]


def jax_core_available(timeout: float = 300.0) -> bool:
    """Whether the JAX package's native core loads here, independent of
    what other processes do at the same moment.

    The JAX package builds its core with an unlocked ``make`` at its first
    use, and six test workers import their test files at once: a worker
    can load the library while another worker's linker is still writing
    it, see a broken file and answer False, and every test gated on it
    would skip.  Here the build runs under one file lock per checkout and
    the load is retried until the library is whole (``native.load`` keeps
    no failure), so only a toolchain that cannot build the core answers
    False."""
    import fcntl
    import hashlib
    from brpc_tpu.butil import native
    if native.available():
        return True
    native_dir = native._NATIVE_DIR
    tag = hashlib.sha1(os.path.abspath(native_dir).encode()).hexdigest()[:12]
    lock = os.path.join(tempfile.gettempdir(),
                        f"brpc_tpu_core_build.{tag}.lock")
    deadline = time.monotonic() + timeout
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        while True:
            try:
                subprocess.run(["make", "-C", native_dir,
                                "libbrpc_tpu_core.so"], capture_output=True,
                               timeout=max(1.0, deadline - time.monotonic()))
            except (OSError, subprocess.TimeoutExpired):
                pass
            if native.available():
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(1.0)
