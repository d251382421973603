"""Live KV migration in the port, held against the JAX package on the CPU.

  * ``TestKvMigration`` of the JAX package (without its autoscaler case):
    each scenario runs on both packages' pools and ``migrate_out`` from
    the same seeded rows — the cutover runs while the source is live and
    the source releases after it, a clean shed latches nothing, a hung
    send trips the transfer-deadline latch which then refuses fast and
    revives on the timer, a raising send latches ``peer_unreachable``,
    the scheduler fence refuses a decoding session, a spilled session
    migrates through a restore.  Outcomes, ``plane_stats()`` deltas and
    ``migration_stats()`` deltas must agree between the packages, and the
    destination's bytes must equal the rows loaded.  Router affinity
    (bind, rebind, unbind, the cardinality cap) is held against the JAX
    router the same way.
  * ``TestLiveMigrationChaos`` on ``mem://``: a client decodes one live
    session the whole time while it migrates A -> B through a killed
    destination, a black-holed destination (the deadline latch fires,
    then the plane revives on its timer and the migration lands) and a
    killed source after cutover: zero client failures, and the
    concatenated token stream equals the JAX package's
    ``reference_generate``.
  * One ``ici://`` migration on the CPU mesh with the plane engaged: the
    payload rides the device plane, the plain ``p2p_copy`` runs once per
    MigrateIn call received, and the destination decodes the JAX
    reference's tokens.
"""
import importlib
import json
import threading
import time
import types

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import serving as jserving
from brpc_tpu.butil import flags as jflags
from brpc_tpu.ici import route as jroute
from brpc_tpu.serving import migration as jmigration
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch import serving as tserving
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.controller import server_controller_pool
from brpc_tpu_torch.serving import migration as tmigration
from examples.disagg_serving import model as jmodel

BPT = jmodel.KV_LAYERS * jmodel.KV_DMODEL

JAX = types.SimpleNamespace(
    name="jax", serving=jserving, flags=jflags, route=jroute,
    migration=jmigration, np=lambda a: a,
    rows=lambda payload, n: np.frombuffer(payload, np.uint8).reshape(n, BPT),
    pool=lambda opts: jserving.PagedKvPool(opts))
PORT = types.SimpleNamespace(
    name="port", serving=tserving, flags=tflags, route=troute,
    migration=tmigration, np=lambda t: t.numpy(),
    rows=lambda payload, n: payload,
    pool=lambda opts: tserving.PagedKvPool(opts, device="cpu"))
_EVENTS = ("down", "reprobe", "revived", "ramp")
_LEDGER = ("migrations_out", "migrations_in", "cutovers", "aborts",
           "bytes_moved")


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every pool, server and channel here is closed by its test; at
    teardown the port's RPC pools must be empty and both migrate planes
    must be up again (the latch is process-wide)."""
    yield
    for fl in (jflags, tflags):
        fl.set_flag("serving_migrate_reprobe_s", 0.05)
    time.sleep(0.1)
    assert jmigration.migrate_health().usable()
    assert tmigration.migrate_health().usable()
    for fl in (jflags, tflags):
        fl.set_flag("serving_migrate_reprobe_s", 0.5)
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


def _rows(tokens):
    kv = np.asarray(jmodel.toy_kv_blocks(tokens))
    seq = len(tokens)
    return kv.reshape(jmodel.KV_LAYERS, seq, jmodel.KV_DMODEL).transpose(
        1, 0, 2).reshape(seq, BPT)


def _mk_pool(pkg, num_blocks=8, block_tokens=8, **kw):
    return pkg.pool(pkg.serving.KvPoolOptions(
        bytes_per_token=BPT, num_blocks=num_blocks,
        block_tokens=block_tokens, use_timers=False, **kw))


def _sender(pkg, dst):
    def send(meta, payload):
        dst.load(meta["session"], pkg.rows(payload, meta["seq_len"]),
                 last_token=meta["last_token"], tenant=meta["tenant"],
                 priority=meta["priority"])
        return True, "", False
    return send


def _plane_delta(pkg, before):
    after = pkg.route.plane_stats()
    return {e: after.get(f"migrate_{e}", 0) - before.get(f"migrate_{e}", 0)
            for e in _EVENTS}


def _ledger_delta(pkg, before):
    after = pkg.migration.migration_stats()
    return {k: after[k] - before[k] for k in _LEDGER}


def _both(scenario, src_kw=None):
    """Run ``scenario(pkg, src, dst)`` on both packages; return each
    package's (result, plane delta, ledger delta)."""
    out = {}
    for pkg in (JAX, PORT):
        src = _mk_pool(pkg, **(src_kw or {}))
        dst = _mk_pool(pkg)
        # the migrate plane is process-wide: a ramp an earlier test file
        # in this worker left pending is taken here, not in the scenario
        pkg.migration.migrate_health().usable()
        p0 = pkg.route.plane_stats()
        l0 = pkg.migration.migration_stats()
        try:
            res = scenario(pkg, src, dst)
        finally:
            src.close()
            dst.close()
        out[pkg.name] = (res, _plane_delta(pkg, p0), _ledger_delta(pkg, l0))
    assert out["jax"] == out["port"]
    return out["port"]


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    for fl in (jflags, tflags):
        fl.set_flag("serving_migrate_reprobe_s", 0.5)


TOKS = [(3 * j) % 499 for j in range(16)]


def test_migrate_out_cutover_then_release():
    def scenario(pkg, src, dst):
        src.load("m1", _rows(TOKS), last_token=TOKS[-1])
        order = []

        def flip():
            assert src.get("m1") is not None    # source still live
            order.append("flip")
        ok, err = pkg.migration.migrate_out(src, "m1", _sender(pkg, dst),
                                            on_cutover=flip)
        assert ok, err
        assert order == ["flip"]
        assert src.get("m1") is None            # released after
        assert np.array_equal(pkg.np(dst.materialize("m1")), _rows(TOKS))
        return ok
    res, plane, ledger = _both(scenario)
    assert plane == dict.fromkeys(_EVENTS, 0)
    assert ledger == {"migrations_out": 1, "migrations_in": 0,
                      "cutovers": 1, "aborts": 0,
                      "bytes_moved": len(TOKS) * BPT}


def test_shed_abort_keeps_source_no_plane_event():
    def scenario(pkg, src, dst):
        src.load("m1", _rows(TOKS), last_token=TOKS[-1])

        def shed(meta, payload):
            return False, "kv pool saturated (shed)", True
        ok, err = pkg.migration.migrate_out(src, "m1", shed)
        assert not ok and "saturated" in err
        assert np.array_equal(pkg.np(src.materialize("m1")), _rows(TOKS))
        return ok, err
    _, plane, ledger = _both(scenario)
    assert plane["down"] == 0 and ledger["aborts"] == 1


def test_transfer_deadline_latches_and_revives():
    def scenario(pkg, src, dst):
        pkg.flags.set_flag("serving_migrate_reprobe_s", 0.1)
        gate = threading.Event()
        try:
            src.load("m1", _rows(TOKS), last_token=TOKS[-1])

            def hung(meta, payload):
                gate.wait(5.0)
                return True, "", False
            t0 = time.monotonic()
            ok, err = pkg.migration.migrate_out(src, "m1", hung,
                                                deadline_ms=150)
            assert not ok and "deadline" in err
            assert time.monotonic() - t0 < 2.0
            calls = []
            ok2, err2 = pkg.migration.migrate_out(
                src, "m1",
                lambda m, p: calls.append(1) or (True, "", False))
            assert not ok2 and "latched" in err2 and not calls
            assert np.array_equal(pkg.np(src.materialize("m1")),
                                  _rows(TOKS))
            gate.set()
            time.sleep(0.15)
            ok3, err3 = pkg.migration.migrate_out(src, "m1",
                                                  _sender(pkg, dst))
            assert ok3, err3
            assert np.array_equal(pkg.np(dst.materialize("m1")),
                                  _rows(TOKS))
            return [ok, ok2, ok3]
        finally:
            gate.set()
    _, plane, ledger = _both(scenario)
    assert plane["down"] == 1 and plane["revived"] == 1
    assert ledger["aborts"] == 2 and ledger["cutovers"] == 1


def test_peer_unreachable_latches_plane():
    def scenario(pkg, src, dst):
        pkg.flags.set_flag("serving_migrate_reprobe_s", 0.05)
        src.load("m1", _rows([3] * 16), last_token=3)

        def dead(meta, payload):
            raise ConnectionError("connection refused")
        ok, err = pkg.migration.migrate_out(src, "m1", dead)
        assert not ok and "ConnectionError" in err
        st = pkg.migration.migration_stats()
        assert st["plane"]["state"] == "down"
        assert st["plane"]["reason"] == "peer_unreachable"
        assert np.array_equal(pkg.np(src.materialize("m1")),
                              _rows([3] * 16))
        time.sleep(0.1)
        assert pkg.migration.migrate_health().usable()   # heal for later
        return ok, err
    _, plane, _ = _both(scenario)
    assert plane["down"] == 1 and plane["revived"] == 1


def test_scheduler_fence_refuses_decoding_session():
    def scenario(pkg, src, dst):
        sched = pkg.serving.ContinuousBatchScheduler(
            src, pkg.serving.BatchSchedulerOptions(
                vocab=jmodel.VOCAB, max_batch=4, auto_start=False))
        try:
            src.load("m1", _rows(TOKS), last_token=TOKS[-1])
            sched.submit(pkg.serving.StepRequest(
                "m1", 50, lambda t: None, lambda *a: None))
            sched.step_once()
            ok, err = pkg.migration.migrate_out(
                src, "m1", _sender(pkg, dst), scheduler=sched)
            assert not ok and "decoding" in err
            return ok, err
        finally:
            sched.stop()
    _both(scenario)


def test_spilled_session_migrates_via_restore():
    def scenario(pkg, src, dst):
        src.load("m1", _rows(TOKS), last_token=TOKS[-1])
        assert src.spill("m1")
        ok, err = pkg.migration.migrate_out(src, "m1", _sender(pkg, dst))
        assert ok, err
        assert src.describe()["tiers"]["restores"] == 1
        assert src.spilled_sessions() == []
        assert np.array_equal(pkg.np(dst.materialize("m1")), _rows(TOKS))
        return ok
    _both(scenario, src_kw=dict(num_blocks=4, host_blocks=4))


def test_pool_describe_carries_the_process_migration_ledger():
    pool = _mk_pool(PORT, host_blocks=2)
    try:
        mig = pool.describe()["tiers"]["migration"]
        assert mig["scope"] == "process"
        assert set(_LEDGER) <= set(mig)
    finally:
        pool.close()


def test_router_affinity_bind_rebind_unbind():
    seen = {}
    for pkg in (JAX, PORT):
        r = pkg.serving.LoadAwareRouter(["ici://0", "ici://1"])
        try:
            assert r.session_url("s") is None
            r.bind_session("s", "ici://0")
            assert r.session_url("s") == "ici://0"
            assert r.rebind("s", "ici://1") == "ici://0"
            assert r.session_url("s") == "ici://1"
            assert r.rebind("new", "ici://0") is None
            d = r.describe()
            assert d["sessions_bound"] == 2 and d["rebinds"] == 1
            r.unbind("s")
            assert r.session_url("s") is None
            for i in range(r.MAX_BOUND_SESSIONS + 10):
                r.bind_session(f"x{i}", "ici://0")
            d = r.describe()
            seen[pkg.name] = (d["sessions_bound"], d["rebinds"],
                              r.session_url("x0"),
                              r.session_url(f"x{r.MAX_BOUND_SESSIONS + 9}"))
        finally:
            r.close()
    assert seen["jax"] == seen["port"]
    assert seen["port"][0] <= tserving.LoadAwareRouter.MAX_BOUND_SESSIONS


# ---- live migration under chaos, over mem:// -----------------------------

def _decode_worker(mesh, name, rank):
    from brpc_tpu_torch.examples.disagg_serving.workers import DecodeService
    server = rpc.Server()
    svc = DecodeService(rank, mesh)
    server.add_service(svc)
    assert server.start(f"mem://{name}") == 0
    return server, svc


def test_migration_chaos_matrix_zero_client_failures():
    """One live session decodes the whole time (the soak, routed by
    affinity) while it migrates A -> B through (a) a killed destination,
    (b) a black-holed destination that trips the transfer deadline, then
    revives on the timer and lands with the cutover, and (c) a killed
    source after cutover.  The soak sees no failure and its stream is the
    JAX reference's tokens, the chunks decoded on B included."""
    from brpc_tpu_torch.ici.mesh import IciMesh
    mesh = IciMesh(ranks=8, device="cpu")
    url_a, url_b = "mem://tmig-a", "mem://tmig-b"
    server_a, svc_a = _decode_worker(mesh, "tmig-a", 2)
    server_b, svc_b = _decode_worker(mesh, "tmig-b", 3)
    router = tserving.LoadAwareRouter([url_a, url_b])
    chans = {}

    def chan(url):
        ch = chans.get(url)
        if ch is None:
            ch = rpc.Channel()
            ch.init(url, options=rpc.ChannelOptions(timeout_ms=30000,
                                                    max_retry=0))
            chans[url] = ch
        return ch

    def call(url, method, body):
        cntl = rpc.Controller()
        resp = chan(url).call_method(f"Decode.{method}", cntl,
                                     EchoRequest(message=json.dumps(body)),
                                     EchoResponse)
        return cntl, resp

    toks = [(7 * j) % 499 for j in range(24)]
    lc = rpc.Controller()
    lc.request_attachment.append(np.asarray(
        jmodel.toy_kv_blocks(toks)).tobytes())
    chan(url_a).call_method("Decode.LoadKv", lc, EchoRequest(
        message=json.dumps({"session": "s", "seq_len": len(toks),
                            "last_token": toks[-1]})), EchoResponse)
    assert not lc.failed(), lc.error_text
    router.bind_session("s", url_a)

    quiesce = threading.Lock()
    stop = threading.Event()
    stream, failures = [], []

    def soak():
        while not stop.is_set():
            with quiesce:
                url = router.session_url("s")
                cntl, resp = call(url, "Decode", {"session": "s",
                                                  "steps": 2,
                                                  "release": False})
                if cntl.failed():
                    failures.append((url, cntl.error_code_,
                                     cntl.error_text))
                else:
                    stream.extend(json.loads(resp.message)["tokens"])
            time.sleep(0.002)

    t = threading.Thread(target=soak, daemon=True)
    before = troute.plane_stats()
    st0 = tmigration.migration_stats()
    try:
        # the latch must outlast a loaded host's gap between the kill and
        # the next MigrateOut (a server restart), so it is 2 s, and each
        # wait for its lapse is longer
        tflags.set_flag("serving_migrate_reprobe_s", 2.0)
        t.start()
        deadline = time.monotonic() + 10
        while len(stream) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(stream) >= 4, "soak never produced tokens"

        # (a) destination killed before commit
        with quiesce:
            svc_b.close()
            server_b.stop()
            cntl, _ = call(url_a, "MigrateOut", {"session": "s",
                                                 "dest": url_b})
            assert cntl.failed() and cntl.error_code_ == rpc.errors.ELIMIT
            st = tmigration.migration_stats()
            assert st["plane"]["state"] == "down"
            assert st["plane"]["reason"] == "peer_unreachable"
            assert svc_a.pool.get("s") is not None
        time.sleep(0.05)

        # B back; the plane is still latched: refused without a dial
        server_b, svc_b = _decode_worker(mesh, "tmig-b", 3)
        with quiesce:
            t0 = time.monotonic()
            cntl, _ = call(url_a, "MigrateOut", {"session": "s",
                                                 "dest": url_b})
            assert cntl.failed() and "latched" in cntl.error_text
            assert time.monotonic() - t0 < 1.0
        time.sleep(2.1)                     # the latch lapses

        # (b) destination black-holed: the transfer deadline fires
        with quiesce:
            gate = threading.Event()
            svc_b.migrate_in_gate = gate
            cntl, _ = call(url_a, "MigrateOut", {"session": "s",
                                                 "dest": url_b,
                                                 "deadline_ms": 250})
            assert cntl.failed() and "deadline" in cntl.error_text
            st = tmigration.migration_stats()
            assert st["plane"]["state"] == "down"
            assert st["plane"]["reason"] == "transfer_deadline"
            assert svc_a.pool.get("s") is not None
            cntl, _ = call(url_a, "MigrateOut", {"session": "s",
                                                 "dest": url_b})
            assert cntl.failed() and "latched" in cntl.error_text
            gate.set()
            svc_b.migrate_in_gate = None
            time.sleep(2.1)
            cntl, resp = call(url_a, "MigrateOut", {"session": "s",
                                                    "dest": url_b,
                                                    "deadline_ms": 5000})
            assert not cntl.failed(), cntl.error_text
            assert json.loads(resp.message)["migrated"]
            assert router.rebind("s", url_b) == url_a
            assert svc_a.pool.get("s") is None
            assert svc_b.pool.get("s") is not None
        time.sleep(0.05)

        # (c) the source killed after cutover
        with quiesce:
            svc_a.close()
            server_a.stop()
        time.sleep(0.05)
    finally:
        stop.set()
        t.join(10)
        tflags.set_flag("serving_migrate_reprobe_s", 0.5)
        for ch in chans.values():
            ch.close()
        svc_b.close()
        server_b.stop()
        svc_a.close()
        server_a.stop()
        router.close()

    assert failures == [], failures
    assert len(stream) >= 10
    want = jmodel.reference_generate(toks, 2)
    assert stream == want * (len(stream) // 2)
    st = tmigration.migration_stats()
    assert st["migrations_out"] >= st0["migrations_out"] + 1
    assert st["migrations_in"] >= st0["migrations_in"] + 1
    assert st["aborts"] >= st0["aborts"] + 4
    after = troute.plane_stats()
    assert after.get("migrate_down", 0) >= before.get("migrate_down", 0) + 2
    assert after.get("migrate_revived", 0) \
        >= before.get("migrate_revived", 0) + 2


def test_decode_mid_migration_served_then_shed_towards_dest():
    """The window between a MigrateOut's release and the caller's rebind:
    a Decode that reaches the source while the transfer is in flight is
    served there, and one that reaches it after the release (async and
    sync) is shed ``ELIMIT`` naming the destination, with no hint, not
    refused as an unknown session.  Following the shed gives the JAX
    reference's tokens; a session loaded back on the source serves there
    again."""
    from brpc_tpu_torch.examples.disagg_serving.workers import migrated_dest
    from brpc_tpu_torch.ici.mesh import IciMesh
    mesh = IciMesh(ranks=8, device="cpu")
    url_a, url_b = "mem://tmid-a", "mem://tmid-b"
    server_a, svc_a = _decode_worker(mesh, "tmid-a", 2)
    server_b, svc_b = _decode_worker(mesh, "tmid-b", 3)
    router = tserving.LoadAwareRouter([url_a, url_b])
    chans = {url: rpc.Channel() for url in (url_a, url_b)}
    for url, ch in chans.items():
        ch.init(url, options=rpc.ChannelOptions(timeout_ms=30000))

    def call(url, method, body, att=None):
        cntl = rpc.Controller()
        if att is not None:
            cntl.request_attachment.append(att)
        resp = chans[url].call_method(f"Decode.{method}", cntl,
                                      EchoRequest(message=json.dumps(body)),
                                      EchoResponse)
        return cntl, resp

    toks = [(5 * j) % 499 for j in range(24)]
    want = jmodel.reference_generate(toks, 2)
    kv = np.asarray(jmodel.toy_kv_blocks(toks)).tobytes()
    load = {"session": "s", "seq_len": len(toks), "last_token": toks[-1]}
    decode = {"session": "s", "steps": 2, "release": False}
    gate = threading.Event()
    try:
        cntl, _ = call(url_a, "LoadKv", load, kv)
        assert not cntl.failed(), cntl.error_text
        router.bind_session("s", url_a)
        svc_b.migrate_in_gate = gate
        mig = {}
        t = threading.Thread(target=lambda: mig.update(r=call(
            url_a, "MigrateOut", {"session": "s", "dest": url_b,
                                  "deadline_ms": 30000})))
        t.start()
        deadline = time.monotonic() + 10
        while svc_b.migrate_in_received < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert svc_b.migrate_in_received == 1, "the transfer never started"
        # mid-transfer: the source copy is still authoritative
        cntl, resp = call(url_a, "Decode", decode)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["tokens"] == want
        gate.set()
        t.join(30)
        cntl, resp = mig["r"]
        assert not cntl.failed(), cntl.error_text
        assert svc_a.pool.get("s") is None
        # released, not yet rebound: both decode paths shed towards B
        for body in (decode, {**decode, "mode": "sync"}):
            cntl, _ = call(url_a, "Decode", body)
            assert cntl.failed() and cntl.error_code_ == rpc.errors.ELIMIT
            assert cntl.retry_after_ms == 0
            assert migrated_dest(cntl) == url_b, cntl.error_text
        assert router.session_url("s") == url_a
        assert router.rebind("s", migrated_dest(cntl)) == url_a
        cntl, resp = call(router.session_url("s"), "Decode", decode)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["tokens"] == want
        # loaded back on A: served there, no stale redirect
        cntl, _ = call(url_a, "LoadKv", load, kv)
        assert not cntl.failed(), cntl.error_text
        cntl, resp = call(url_a, "Decode", decode)
        assert not cntl.failed(), cntl.error_text
        assert migrated_dest(cntl) is None
        assert json.loads(resp.message)["tokens"] == want
    finally:
        gate.set()
        for ch in chans.values():
            ch.close()
        for svc, server in ((svc_a, server_a), (svc_b, server_b)):
            svc.close()
            server.stop()
        router.close()


# ---- one migration over ici://, on the device plane ----------------------

def test_ici_migration_rides_the_plane_once_per_migrate_in(monkeypatch):
    from brpc_tpu_torch.examples.disagg_serving import model as tmodel
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        close_services, start_decode_worker)
    from brpc_tpu_torch.ici import device_plane as dp
    from brpc_tpu_torch.ici.mesh import IciMesh
    # the module (the package exports its wrapper under the same name)
    p2p = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    flag_names = ("ici_device_plane", "ici_device_plane_host_mesh",
                  "ici_device_plane_threshold")
    saved = {n: tflags.get_flag(n) for n in flag_names}
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 64 * 1024)
    src_w = start_decode_worker("ici://2")
    dst_w = start_decode_worker("ici://3")
    src, dst = (next(iter(w.services().values())) for w in (src_w, dst_w))
    ch2, ch3 = rpc.Channel(), rpc.Channel()
    ch2.init("ici://2", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    ch3.init("ici://3", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    tokens = np.random.default_rng(11).integers(0, jmodel.VOCAB,
                                                256).tolist()
    try:
        kv = mesh.own(tmodel.toy_kv_blocks(tokens, "cpu"), 1)
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(kv)
        ch2.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": "mv", "seq_len": len(tokens),
                                "last_token": tokens[-1]})), EchoResponse)
        assert not cntl.failed(), cntl.error_text

        copies = []
        real = p2p.p2p_copy_plain

        def counted(s, d):
            copies.append(s.numel())
            return real(s, d)
        monkeypatch.setattr(p2p, "p2p_copy_plain", counted)
        transfers0 = dp.plane().stats()["transfers"]
        received0 = dst.migrate_in_received
        cntl = rpc.Controller()
        resp = ch2.call_method("Decode.MigrateOut", cntl, EchoRequest(
            message=json.dumps({"session": "mv", "dest": "ici://3"})),
            EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["migrated"]
        monkeypatch.setattr(p2p, "p2p_copy_plain", real)
        received = dst.migrate_in_received - received0
        assert received == 1
        assert len(copies) == received == \
            dp.plane().stats()["transfers"] - transfers0
        assert copies == [len(tokens) * BPT]
        assert src.pool.get("mv") is None
        assert np.array_equal(dst.pool.materialize("mv").numpy(),
                              _rows(tokens))
        cntl = rpc.Controller()
        resp = ch3.call_method("Decode.Decode", cntl, EchoRequest(
            message=json.dumps({"session": "mv", "steps": 8})),
            EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["tokens"] == \
            jmodel.reference_generate(tokens, 8)
    finally:
        ch2.close()
        ch3.close()
        close_services(src_w, dst_w)
        for n, v in saved.items():
            tflags.set_flag(n, v)
        IciMesh.set_default(None)
