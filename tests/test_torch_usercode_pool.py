"""The port's usercode pool, held against the JAX package on the CPU.

  * The pool-level cases of the JAX package's ``tests/test_usercode_pool.py``
    run on both packages' ``UsercodePool`` with the same expectations: the
    cached capability probe and the kind resolution, the share-nothing
    contract, the isolated round trip, a handler error that is not a
    worker death, a worker death requeued with no visible failure, the
    fallback running the same source, the fallback's cached namespace,
    re-registration reaching the subinterpreter workers, a call after
    shutdown failing fast, the shutdown sweep of a stranded task, an
    abandoned task not run, and a clean process exit after shutdown.
  * Parity: the same seeded payloads through the same registered source
    give the same bytes on both packages' pools.
  * The server cases run on the port over ``mem://`` and over ``ici://``
    on a CPU mesh: CPU-bound handlers on the backup pool do not starve
    another socket, the pool serves and shuts down with the server, a
    draining server bounces pooled requests with ELOGOFF, and a handler
    hands its payload bytes to an isolated handler.
"""
from __future__ import annotations

import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.rpc import usercode_pool as jpool
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.bthread.scheduler import TaskControl
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import usercode_pool as tpool
from brpc_tpu_torch.rpc.controller import server_controller_pool

PKGS = [pytest.param(jpool, id="jax"), pytest.param(tpool, id="port")]
_ISOLATION = tpool.probe_isolation()
needs_isolation = pytest.mark.skipif(
    not _ISOLATION.functional,
    reason=f"no subinterpreter support: {_ISOLATION.reason}")


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server, channel and pool here is closed by its test."""
    yield
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


# ---- the pool, on both packages ------------------------------------------

def test_probe_agrees_with_the_jax_package():
    caps = tpool.probe_isolation()
    assert caps is tpool.probe_isolation()        # once per process
    assert tuple(caps) == tuple(jpool.probe_isolation())
    assert caps.mode in ("free-threading", "subinterp",
                         "subinterp-shared-gil", "none")
    if not caps.scaling:
        assert caps.reason


@pytest.mark.parametrize("mod", PKGS)
def test_pool_kind_resolution(mod):
    caps = mod.probe_isolation()
    p = mod.UsercodePool(kind="auto", workers=1)
    try:
        if caps.mode == "free-threading":
            assert p.kind == "pthread"
        elif caps.functional:
            assert p.kind == "subinterp"
        else:
            assert p.kind == "pthread"
    finally:
        p.shutdown()
    with pytest.raises(ValueError):
        mod.UsercodePool(kind="nope")


@pytest.mark.parametrize("mod", PKGS)
def test_non_bytes_payload_refused(mod):
    p = mod.UsercodePool(kind="pthread", workers=1)
    try:
        p.register("M.h", "def handle(payload):\n    return payload\n")
        with pytest.raises(TypeError, match="share-nothing"):
            p.call_isolated("M.h", {"an": "object"})
        with pytest.raises(TypeError, match="share-nothing"):
            p.call_isolated("M.h", object())
        assert p.contract_rejections == 2
        assert p.call_isolated("M.h", b"x") == b"x"
        assert p.call_isolated("M.h", bytearray(b"y")) == b"y"
        assert p.call_isolated("M.h", memoryview(b"z")) == b"z"
    finally:
        p.shutdown()


@pytest.mark.parametrize("mod", PKGS)
def test_non_source_registration_refused(mod):
    p = mod.UsercodePool(kind="pthread", workers=1)
    try:
        with pytest.raises(TypeError, match="share-nothing"):
            p.register("M.h", lambda payload: payload)
    finally:
        p.shutdown()


@needs_isolation
@pytest.mark.parametrize("mod", PKGS)
def test_isolated_call_roundtrip(mod):
    p = mod.UsercodePool(kind="subinterp", workers=2)
    try:
        p.register("M.h", "def handle(payload):\n    return b'ok:' + payload\n")
        assert p.call_isolated("M.h", b"abc") == b"ok:abc"
        assert p.isolation_active
        d = p.describe()
        assert d["isolation_workers"] == 2
        assert d["registered_isolated"] == ["M.h"]
        assert d["isolation"]["mode"] == _ISOLATION.mode
    finally:
        p.shutdown()


@needs_isolation
@pytest.mark.parametrize("mod", PKGS)
def test_handler_error_surfaces_not_worker_death(mod):
    p = mod.UsercodePool(kind="subinterp", workers=1)
    try:
        p.register("M.boom", "def handle(payload):\n"
                             "    raise ValueError('boom')\n")
        with pytest.raises(RuntimeError, match="boom"):
            p.call_isolated("M.boom", b"x")
        assert p.worker_deaths == 0
        p.register("M.ok", "def handle(payload):\n    return payload\n")
        assert p.call_isolated("M.ok", b"y") == b"y"
    finally:
        p.shutdown()


@needs_isolation
@pytest.mark.parametrize("mod", PKGS)
def test_worker_death_requeues_with_zero_visible_failures(mod):
    p = mod.UsercodePool(kind="subinterp", workers=2)
    try:
        p.register("M.h", "def handle(payload):\n    return payload\n")
        assert p.call_isolated("M.h", b"warm") == b"warm"
        p.chaos_kill_next = True
        assert p.call_isolated("M.h", b"survives") == b"survives"
        assert p.worker_deaths == 1 and p.requeues == 1
        assert p.describe()["isolation_workers"] == 2
    finally:
        p.shutdown()


@pytest.mark.parametrize("mod", PKGS)
def test_capability_fallback_runs_same_source(mod):
    p = mod.UsercodePool(kind="pthread", workers=1)
    try:
        assert not p.isolation_active
        p.register("M.h", "def handle(payload):\n    return b'fb:' + payload\n")
        assert p.call_isolated("M.h", b"x") == b"fb:x"
    finally:
        p.shutdown()


@pytest.mark.parametrize("mod", PKGS)
def test_call_isolated_after_shutdown_fails_fast(mod):
    p = mod.UsercodePool(kind="pthread", workers=1)
    p.register("M.h", "def handle(payload):\n    return payload\n")
    p.shutdown()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stopped"):
        p.call_isolated("M.h", b"x")
    assert time.monotonic() - t0 < 1.0


@pytest.mark.parametrize("mod", PKGS)
def test_fallback_namespace_cached_across_calls(mod):
    p = mod.UsercodePool(kind="pthread", workers=1)
    try:
        p.register("M.h", "import itertools\n"
                          "_c = itertools.count()\n"
                          "def handle(payload):\n"
                          "    return str(next(_c)).encode()\n")
        assert p.call_isolated("M.h", b"") == b"0"
        assert p.call_isolated("M.h", b"") == b"1"
        p.register("M.h", "def handle(payload):\n    return b'v2'\n")
        assert p.call_isolated("M.h", b"") == b"v2"
    finally:
        p.shutdown()


@needs_isolation
@pytest.mark.parametrize("mod", PKGS)
def test_reregistration_reaches_subinterp_workers(mod):
    p = mod.UsercodePool(kind="subinterp", workers=1)
    try:
        p.register("M.h", "def handle(payload):\n    return b'v1'\n")
        assert p.call_isolated("M.h", b"") == b"v1"
        p.register("M.h", "def handle(payload):\n    return b'v2'\n")
        assert p.call_isolated("M.h", b"") == b"v2"
    finally:
        p.shutdown()


@needs_isolation
@pytest.mark.parametrize("mod", PKGS)
def test_shutdown_sweeps_stranded_tasks(mod):
    p = mod.UsercodePool(kind="subinterp", workers=1)
    stale = mod._IsoTask("M.h", b"y")
    p._iso_queue.put(stale)
    t0 = time.monotonic()
    p.shutdown()
    assert stale.event.wait(5), "stranded task never answered"
    assert stale.error == "usercode pool stopped"
    assert time.monotonic() - t0 < 6.0


@needs_isolation
@pytest.mark.parametrize("mod", PKGS)
def test_abandoned_task_not_executed_after_timeout(mod):
    p = mod.UsercodePool(kind="subinterp", workers=1)
    try:
        p.register("M.count", "import time\n"
                              "_n = [0]\n"
                              "def handle(payload):\n"
                              "    if payload == b'slow':\n"
                              "        time.sleep(0.5)\n"
                              "    elif payload == b'count':\n"
                              "        return str(_n[0]).encode()\n"
                              "    _n[0] += 1\n"
                              "    return b'ok'\n")
        assert p.call_isolated("M.count", b"x") == b"ok"
        wedge = threading.Thread(
            target=lambda: p.call_isolated("M.count", b"slow"))
        wedge.start()
        time.sleep(0.05)
        with pytest.raises(TimeoutError):
            p.call_isolated("M.count", b"y", timeout=0.1)
        wedge.join(5)
        assert p.call_isolated("M.count", b"count") == b"2"
    finally:
        p.shutdown()


@needs_isolation
def test_process_exit_after_shutdown_does_not_abort():
    """shutdown() joins the isolation workers so their subinterpreters
    are gone before finalization, in a process that loaded torch."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from brpc_tpu_torch.rpc.usercode_pool import UsercodePool\n"
            "p = UsercodePool(kind='subinterp', workers=2)\n"
            "p.register('M.h', 'def handle(payload):\\n    return payload\\n')\n"
            "assert p.call_isolated('M.h', b'x') == b'x'\n"
            "p.shutdown()\n"
            "print('CLEAN')\n") % __file__.rsplit("/", 2)[0]
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr[-500:])
    assert "CLEAN" in r.stdout


_PARITY_SRC = ("import zlib\n"
               "def handle(payload):\n"
               "    crc = zlib.crc32(payload).to_bytes(4, 'big')\n"
               "    return crc + bytes(reversed(payload))\n")


@pytest.mark.parametrize("kind", ["pthread", "auto"])
def test_isolated_results_agree_with_the_jax_pool(kind):
    rng = np.random.default_rng(17)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 4096, 24)]
    got = []
    for mod in (jpool, tpool):
        p = mod.UsercodePool(kind=kind, workers=2)
        try:
            p.register("M.crc", _PARITY_SRC)
            got.append([p.call_isolated("M.crc", b) for b in payloads])
            d = p.describe()
            assert d["isolated_calls"] == len(payloads)
            assert d["contract_rejections"] == 0
        finally:
            p.shutdown()
    assert got[0] == got[1]


# ---- the pool behind a port server ------------------------------------------

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")
_EPS = iter(range(10_000))


@pytest.fixture(params=["mem", "ici"])
def addrs(request):
    """Two fresh endpoints on the plane."""
    if request.param == "mem":
        n = next(_EPS)
        yield (f"mem://pool-a-{n}", f"mem://pool-b-{n}")
        return
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    IciMesh.set_default(IciMesh(ranks=8, device="cpu"))
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 4096)
    yield ("ici://4", "ici://6")
    for n, v in saved.items():
        tflags.set_flag(n, v)
    IciMesh.set_default(None)


class SpinService(rpc.Service):
    """A hostile handler: pure-Python compute until the deadline, never
    parking in a butex."""

    SPIN_S = 0.6

    def __init__(self):
        self.entered = threading.Semaphore(0)

    @rpc.method(EchoRequest, EchoResponse)
    def Spin(self, cntl, request, response, done):
        self.entered.release()
        deadline = time.monotonic() + self.SPIN_S
        x = 1
        while time.monotonic() < deadline:
            x = (x * 1103515245 + 12345) & 0x7FFFFFFF
        response.message = str(x)
        done()


class EchoService(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "echo:" + request.message
        done()


def _channel(target, timeout_ms=10000, max_retry=0):
    ch = rpc.Channel()
    ch.init(target, options=rpc.ChannelOptions(timeout_ms=timeout_ms,
                                       max_retry=max_retry))
    return ch


def test_cpu_bound_handlers_do_not_starve_other_sockets(addrs):
    nspin = TaskControl.instance().concurrency + 2
    spin_svc = SpinService()
    srv_a = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                         usercode_backup_threads=nspin + 2))
    srv_a.add_service(spin_svc)
    assert srv_a.start(addrs[0]) == 0
    srv_b = rpc.Server()
    srv_b.add_service(EchoService())
    assert srv_b.start(addrs[1]) == 0
    ch_a = _channel(addrs[0], timeout_ms=30000)
    ch_b = _channel(addrs[1])
    try:
        pending = []
        for i in range(nspin):
            cntl = rpc.Controller()
            ch_a.call_method("SpinService.Spin", cntl,
                             EchoRequest(message=str(i)), EchoResponse,
                             done=lambda c: None)
            pending.append(cntl)
        for _ in range(nspin):
            assert spin_svc.entered.acquire(timeout=10), \
                "spin handlers never all started"
        t0 = time.monotonic()
        cntl = rpc.Controller()
        resp = ch_b.call_method("EchoService.Echo", cntl,
                                EchoRequest(message="through"), EchoResponse)
        dt = time.monotonic() - t0
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "echo:through"
        assert dt < 0.4, f"fast RPC starved behind CPU-bound usercode: {dt}"
        for cntl in pending:
            cntl.join(30)
            assert not cntl.failed(), cntl.error_text
    finally:
        ch_a.close()
        ch_b.close()
        srv_a.stop()
        srv_b.stop()


def test_usercode_pool_lifecycle_and_results(addrs):
    srv = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                       usercode_backup_threads=2))
    srv.add_service(EchoService())
    assert srv.start(addrs[0]) == 0
    assert srv.usercode_pool is not None
    ch = _channel(addrs[0])
    try:
        for i in range(8):
            cntl = rpc.Controller()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  EchoRequest(message=str(i)), EchoResponse)
            assert not cntl.failed() and resp.message == f"echo:{i}"
        assert srv.inflight_requests() == 0
    finally:
        ch.close()
        srv.stop()
    assert srv.usercode_pool is None


def test_drain_bounces_pooled_requests_with_elogoff(addrs):
    srv = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                       usercode_backup_threads=2))
    srv.add_service(EchoService())
    assert srv.start(addrs[0]) == 0
    ch = _channel(addrs[0])
    try:
        cntl = rpc.Controller()
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="ok"),
                       EchoResponse)
        assert not cntl.failed(), cntl.error_text
        srv._draining = True
        cntl = rpc.Controller()
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="x"),
                       EchoResponse)
        assert cntl.error_code == errors.ELOGOFF
        assert srv.inflight_requests() == 0
    finally:
        srv._draining = False
        ch.close()
        srv.stop()


def test_handler_hands_payload_bytes_to_an_isolated_handler(addrs):
    """A pooled handler runs registered source on the isolation backend:
    only bytes cross, and the result comes back as the response."""
    srv = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                       usercode_backup_threads=2))

    class Iso(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Crc(self, cntl, request, response, done):
            out = srv.usercode_pool.call_isolated(
                "Iso.Crc", request.message.encode())
            response.message = out.hex()
            done()

    srv.add_service(Iso())
    assert srv.start(addrs[0]) == 0
    srv.usercode_pool.register("Iso.Crc", _PARITY_SRC)
    ref = jpool.UsercodePool(kind="pthread", workers=1)
    ref.register("Iso.Crc", _PARITY_SRC)
    ch = _channel(addrs[0])
    try:
        for msg in ("a", "bcd", "x" * 300):
            cntl = rpc.Controller()
            resp = ch.call_method("Iso.Crc", cntl, EchoRequest(message=msg),
                                  EchoResponse)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == ref.call_isolated(
                "Iso.Crc", msg.encode()).hex()
        assert srv.usercode_pool.describe()["isolated_calls"] == 3
    finally:
        ref.shutdown()
        ch.close()
        srv.stop()
