"""The serving modules of the port against the JAX package's, on the CPU.

The same seeded inputs go through ``brpc_tpu.serving`` (numpy arenas) and
``brpc_tpu_torch.serving`` (torch tensors, ``device="cpu"``):

  * ``PagedKvPool``: one seeded sequence of loads, prefix-shared loads,
    reloads, releases, pins, eviction under pressure across bands,
    saturation and ``expire_idle(now=...)`` must leave identical block
    tables, free lists, ``describe()`` counters and snapshot bytes;
  * ``ContinuousBatchScheduler``: the same submissions, driven by
    ``step_once()``, give identical tokens and equal step/preempt counts;
  * the KV handoff's last leg: a DEVICE attachment (a CPU tensor here)
    and a many-segment HOST attachment land in the pool byte-equal to the
    JAX load of the same bytes, with the same route counter;
  * ``LoadAwareRouter`` feedback collapses a failing target's weight, as
    the JAX router's does;
  * the request context (priority, tenant, deadline budget, retry hint)
    crosses the port's wire both ways.

Tolerances are exact throughout.
"""
import json
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
from brpc_tpu.butil.iobuf import IOBuf as JaxIOBuf
from brpc_tpu import serving as jserving
from brpc_tpu.serving import kv_source as jkv_source
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch import serving
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.controller import server_controller_pool
from brpc_tpu_torch.serving import kv_source
from examples.disagg_serving import model as jmodel
from tests.torch_census import custody_census  # noqa: F401  (fixture)

BPT = jmodel.KV_LAYERS * jmodel.KV_DMODEL

# describe() keys that mean the same thing in both packages
_POOL_KEYS = ("blocks_total", "blocks_free", "blocks_used", "block_tokens",
              "utilization", "sessions", "pinned", "blocks_by_tenant",
              "loads", "bytes_in", "evictions", "expired", "fill_aborts",
              "by_tenant", "ttl_s")
_PREFIX_KEYS = ("shared_blocks", "prefix_hits", "commit_races",
                "unlocked_fills", "logical_blocks", "physical_blocks",
                "sharing_ratio")
_SCHED_KEYS = ("active", "pending_by_band", "max_batch", "steps", "tokens",
               "batch_occupancy_avg", "admitted", "retired", "preempted",
               "deadline_expired", "rejected")


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every pool and scheduler here is closed by its test; at teardown
    the port's RPC pools must be empty too."""
    yield
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _pools(clock, **kw):
    opts = dict(bytes_per_token=64, num_blocks=24, block_tokens=8,
                use_timers=False, ttl_s=50.0,
                tenant_weights={"gold": 4, "bronze": 1})
    opts.update(kw)
    jp = jserving.PagedKvPool(jserving.KvPoolOptions(**opts), now=clock)
    tp = serving.PagedKvPool(serving.KvPoolOptions(**opts), device="cpu",
                             now=clock)
    return jp, tp


def _same_state(jp, tp, sessions):
    for s in sessions:
        a, b = jp.get(s), tp.get(s)
        assert (a is None) == (b is None), s
        if a is None:
            continue
        assert list(map(int, a.blocks)) == list(map(int, b.blocks)), s
        assert (a.seq_len, a.acc, a.last_token, a.pinned, a.priority,
                a.tenant, a.last_used, a.release_pending) == \
            (b.seq_len, b.acc, b.last_token, b.pinned, b.priority,
             b.tenant, b.last_used, b.release_pending), s
        ja, tb = jp.materialize(s), tp.materialize(s)
        if ja is None:
            assert tb is None, s
        else:
            assert np.array_equal(ja, tb.numpy()), s
        assert jp.evicted_reason(s) == tp.evicted_reason(s), s
    assert jp._free == tp._free
    jd, td = jp.describe(), tp.describe()
    for k in _POOL_KEYS:
        assert jd[k] == td[k], k
    for k in _PREFIX_KEYS:
        assert jd["prefix"][k] == td["prefix"][k], k


def _apply(pool, op):
    """One operation; returns its outcome (an exception's type name)."""
    kind, args = op[0], op[1:]
    try:
        if kind == "load":
            session, rows, last, tenant, pri = args
            return int(pool.load(session, rows, last_token=last,
                                 tenant=tenant, priority=pri).acc)
        if kind == "pin":
            return pool.pin(args[0])
        if kind == "unpin":
            return pool.unpin(args[0])
        if kind == "release":
            return pool.release(args[0])
        if kind == "touch":
            return pool.touch(args[0])
        if kind == "expire":
            return pool.expire_idle(now=args[0])
        raise AssertionError(kind)
    except (serving.PoolSaturated, serving.SessionBusy,
            jserving.PoolSaturated, jserving.SessionBusy, ValueError) as e:
        return type(e).__name__


def _seeded_ops(rng):
    """Loads with shared prefixes, reloads, pins, releases, pressure
    across bands and tenants, and expiry."""
    def rows(n):
        return rng.integers(0, 256, (n, 64), dtype=np.uint8)

    base = rows(40)
    ops = [
        ("load", "a", base[:20], 5, "gold", 2),
        # shares a's two full blocks, diverges in block 3
        ("load", "b", np.concatenate([base[:16], rows(7)]), 6, "bronze", 2),
        ("load", "c", rows(30), 7, "bronze", 3),
        ("load", "d", base[:24], 8, "", 1),          # 3 shared blocks
        ("tick", 5.0),
        ("touch", "a"),
        ("pin", "b"),
        ("load", "b", rows(9), 9, "bronze", 2),      # pinned: SessionBusy
        ("release", "b"),                            # deferred to unpin
        ("pin", "b"),                                # refused: released
        ("tick", 1.0),
        # pressure: needs 8 blocks, 4 free -> evicts band 3 first (c)
        ("load", "e", rows(60), 10, "gold", 2),
        ("unpin", "b"),                              # frees b now
        ("load", "f", base[:40], 11, "bronze", 3),   # evicts within band
        ("load", "g", rows(190), 12, "", 0),         # saturated
        ("load", "a", base[:20], 5, "gold", 2),      # same-content reload
        ("pin", "a"),
        ("tick", 30.0),
        ("touch", "e"),
        ("tick", 25.0),
        ("expire", None),                            # a pinned, e fresh
        ("unpin", "a"),
        ("load", "h", rows(1), 13, "silver", 1),
        ("expire", 2000.0),
    ]
    return ops


@pytest.mark.parametrize("seed", range(3))
def test_pool_sequence_matches_jax(seed):
    clock = _Clock()
    jp, tp = _pools(clock)
    sessions = list("abcdefgh")
    try:
        for op in _seeded_ops(np.random.default_rng(seed)):
            if op[0] == "tick":
                clock.t += op[1]
                continue
            if op[0] == "expire" and op[1] is None:
                op = ("expire", clock.t)
            assert _apply(jp, op) == _apply(tp, op), op
            _same_state(jp, tp, sessions)
        d = tp.describe()
        assert d["evictions"] > 0 and d["expired"] > 0
        assert d["prefix"]["prefix_hits"] > 0
        # one CRC pass per load that had a full block, counted
        assert d["prefix"]["crc_d2h_passes"] > 0
    finally:
        jp.close()
        tp.close()


def test_pool_eviction_across_bands_and_tenants_matches_jax():
    """Victim order (band, tenant weight, LRU) on a full pool."""
    clock = _Clock()
    jp, tp = _pools(clock, num_blocks=12, block_tokens=4)
    rng = np.random.default_rng(11)
    specs = [("p0", 2, "gold"), ("p1", 2, "bronze"), ("p2", 3, "gold"),
             ("p3", 1, "bronze"), ("p4", 3, "bronze"), ("p5", 2, "")]
    try:
        for name, pri, tenant in specs:
            rows = rng.integers(0, 256, (8, 64), dtype=np.uint8)
            op = ("load", name, rows, 1, tenant, pri)
            assert _apply(jp, op) == _apply(tp, op)
            clock.t += 1.0
        for pri in (3, 2, 1, 0):
            op = ("load", f"q{pri}", rng.integers(
                0, 256, (12, 64), dtype=np.uint8), 2, "gold", pri)
            assert _apply(jp, op) == _apply(tp, op)
            _same_state(jp, tp, [s for s, _, _ in specs]
                        + [f"q{p}" for p in range(4)])
    finally:
        jp.close()
        tp.close()


def test_timer_sweep_reclaims_an_idle_session_without_traffic():
    """The TTL sweep runs on the port's TimerThread: a parked session on
    an otherwise idle pool is reclaimed with no further calls."""
    pool = serving.PagedKvPool(serving.KvPoolOptions(
        bytes_per_token=64, num_blocks=8, block_tokens=4, ttl_s=0.05,
        sweep_interval_s=0.02), device="cpu")
    try:
        pool.load("idle", np.ones((6, 64), np.uint8), last_token=1)
        deadline = time.monotonic() + 5.0
        while pool.sessions() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.sessions() == 0
        assert pool.describe()["expired"] == 1
        assert pool.evicted_reason("idle") == "expired"
        assert pool.describe()["blocks_free"] == 8
    finally:
        pool.close()


def test_concurrent_fills_keep_custody_exact():
    """More loader threads than cores fill outside the pool lock while
    others release, pin and unpin, with a short switch interval: every
    committed session reads back its own bytes, and at the end every
    block is either free or owned (free + physical == num_blocks)."""
    import sys
    pool = serving.PagedKvPool(serving.KvPoolOptions(
        bytes_per_token=64, num_blocks=64, block_tokens=4,
        use_timers=False), device="cpu")
    errors = []

    def worker(k):
        rng = np.random.default_rng(k)
        try:
            for i in range(40):
                s = f"w{k}-{i % 5}"
                rows = rng.integers(0, 256, (int(rng.integers(1, 13)), 64),
                                    dtype=np.uint8)
                if i % 3 == 0:
                    rows[:4] = 9             # a shared first block
                try:
                    pool.load(s, rows, last_token=i, priority=i % 4)
                except (serving.PoolSaturated, serving.SessionBusy):
                    continue
                if pool.pin(s):
                    got = pool.materialize(s)
                    pool.unpin(s)
                    if got is not None and not np.array_equal(
                            got.numpy(), rows):
                        errors.append((s, "bytes"))
                if i % 2:
                    pool.release(s)
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        d = pool.describe()
        assert d["blocks_free"] + d["prefix"]["physical_blocks"] == 64
        assert d["pinned"] == 0
        assert d["prefix"]["prefix_hits"] > 0
    finally:
        pool.close()


def _rows(tokens):
    """Prompt -> token-major pool rows through the JAX model."""
    kv = np.asarray(jmodel.toy_kv_blocks(tokens))
    seq = len(tokens)
    return kv.reshape(jmodel.KV_LAYERS, seq, jmodel.KV_DMODEL).transpose(
        1, 0, 2).reshape(seq, BPT)


class _Sink:
    def __init__(self):
        self.tokens = None
        self.error = None

    def emit(self, tokens):
        self.tokens = list(tokens)

    def fail(self, code, text, retry_after_ms):
        self.error = (code, text, retry_after_ms)


def _sched_pair(max_batch):
    clock = _Clock()
    opts = dict(bytes_per_token=BPT, num_blocks=40, block_tokens=8,
                use_timers=False)
    jp = jserving.PagedKvPool(jserving.KvPoolOptions(**opts), now=clock)
    tp = serving.PagedKvPool(serving.KvPoolOptions(**opts), device="cpu",
                             now=clock)
    now_us = (lambda: 10 ** 9)
    js = jserving.ContinuousBatchScheduler(
        jp, jserving.BatchSchedulerOptions(
            vocab=jmodel.VOCAB, max_batch=max_batch, auto_start=False),
        now_us=now_us)
    ts = serving.ContinuousBatchScheduler(
        tp, serving.BatchSchedulerOptions(
            vocab=jmodel.VOCAB, max_batch=max_batch, auto_start=False),
        now_us=now_us)
    return (jp, js, jserving.StepRequest), (tp, ts, serving.StepRequest)


def test_scheduler_tokens_and_counts_match_jax():
    """Staggered joins, a full roster, interactive preemption, a dead
    deadline and an unknown session, stepped by hand on both sides."""
    sides = _sched_pair(max_batch=3)
    specs = {f"s{i}": ([(7 * i + j) % 997 for j in range(12 + 9 * i)],
                       4 + 3 * i, 3 if i % 2 else 2) for i in range(4)}
    late = {"late": ([(13 * j) % 499 for j in range(21)], 6, 0),
            "dead": ([5] * 8, 3, 2)}
    sinks = ({}, {})
    try:
        for (pool, sched, Req), sk in zip(sides, sinks):
            for s, (tokens, steps, pri) in specs.items():
                pool.load(s, _rows(tokens), last_token=tokens[-1],
                          priority=pri)
                sk[s] = _Sink()
                sched.submit(Req(s, steps, sk[s].emit, sk[s].fail,
                                 priority=pri))
            sk["ghost"] = _Sink()
            sched.submit(Req("ghost", 2, sk["ghost"].emit, sk["ghost"].fail))
        for step in range(30):
            if step == 3:
                for (pool, sched, Req), sk in zip(sides, sinks):
                    for s, (tokens, steps, pri) in late.items():
                        pool.load(s, _rows(tokens), last_token=tokens[-1],
                                  priority=pri)
                        sk[s] = _Sink()
                        sched.submit(Req(
                            s, steps, sk[s].emit, sk[s].fail, priority=pri,
                            deadline_us=1 if s == "dead" else None))
            assert sides[0][1].step_once() == sides[1][1].step_once()
            assert sides[0][1].active() == sides[1][1].active()
        jd, td = sides[0][1].describe(), sides[1][1].describe()
        for k in _SCHED_KEYS:
            assert jd[k] == td[k], k
        assert td["preempted"] >= 1 and td["deadline_expired"] == 1
        for s in list(specs) + list(late) + ["ghost"]:
            assert sinks[0][s].tokens == sinks[1][s].tokens, s
            assert sinks[0][s].error == sinks[1][s].error, s
        for s, (tokens, steps, _) in {**specs, "late": late["late"]}.items():
            assert sinks[1][s].tokens == jmodel.reference_generate(
                tokens, steps), s
        assert sinks[1]["ghost"].error[0] == rpc.errors.EREQUEST
        assert sinks[1]["dead"].error[0] == rpc.errors.ERPCTIMEDOUT
    finally:
        for pool, sched, _ in sides:
            sched.stop()
            pool.close()


def test_step_tokens_is_the_numpy_step():
    """The port's one-function step against the JAX scheduler's own steps
    (``_step_numpy`` and the jit-compiled ``_step_compiled``) on a random
    roster with prefix-shared block tables."""
    rng = np.random.default_rng(3)
    bt, nblocks, b = 8, 50, 17
    pos_flat = rng.integers(0, 261_121, nblocks * bt)
    seq = rng.integers(1, 80, b)
    tbl = np.zeros((b, 10), np.int64)
    for k in range(b):
        n = (seq[k] + bt - 1) // bt
        tbl[k, :n] = rng.integers(0, nblocks, n)
    acc = rng.integers(0, 10 ** 8, b)
    prev = rng.integers(0, jmodel.VOCAB, b)
    stepi = rng.integers(0, 64, b)
    # the JAX scheduler's roster arrays, as its _build_arrays leaves them
    jsched = types.SimpleNamespace(
        pool=types.SimpleNamespace(pos_sums_flat=pos_flat),
        options=types.SimpleNamespace(vocab=jmodel.VOCAB),
        _tbl=tbl, _seq=seq, _acc=acc, _prev=prev, _stepi=stepi,
        _rows=np.arange(b), _jit_cache={})
    want = jserving.ContinuousBatchScheduler._step_numpy(jsched, bt)
    compiled = jserving.ContinuousBatchScheduler._step_compiled(jsched, bt)
    t = [torch.from_numpy(np.asarray(x, np.int64))
         for x in (pos_flat, tbl, seq, acc, prev, stepi)]
    got = serving.step_tokens(*t, block_tokens=bt, vocab=jmodel.VOCAB)
    assert got.tolist() == want.tolist() == compiled.tolist()


def _wire(tokens):
    return np.asarray(jmodel.toy_kv_blocks(tokens))


def test_device_attachment_lands_like_jax():
    """A DEVICE attachment (the tensor the plane delivered; a CPU tensor
    here) scatters into the pool byte-equal to the JAX load of the same
    bytes, on the same route."""
    import jax.numpy as jnp
    clock = _Clock()
    opts = dict(bytes_per_token=BPT, num_blocks=16, block_tokens=8,
                use_timers=False)
    jp = jserving.PagedKvPool(jserving.KvPoolOptions(**opts), now=clock)
    tp = serving.PagedKvPool(serving.KvPoolOptions(**opts), device="cpu",
                             now=clock)
    tokens = [(11 * j) % 997 for j in range(37)]
    wire = _wire(tokens)
    try:
        j0, t0 = jkv_source.kv_load_stats(), kv_source.kv_load_stats()
        jatt = JaxIOBuf()
        jatt.append_device_array(jnp.asarray(wire))
        jserving.load_wire_attachment(jp, jatt, "s", len(tokens),
                                      jmodel.KV_LAYERS, jmodel.KV_DMODEL,
                                      last_token=tokens[-1])
        tatt = IOBuf()
        tatt.append_device_array(torch.from_numpy(wire.copy()))
        serving.load_wire_attachment(tp, tatt, "s", len(tokens),
                                     jmodel.KV_LAYERS, jmodel.KV_DMODEL,
                                     last_token=tokens[-1])
        j1, t1 = jkv_source.kv_load_stats(), kv_source.kv_load_stats()
        for k in ("adopted", "scattered", "materialized", "copy_bytes"):
            assert j1[k] - j0[k] == t1[k] - t0[k], k
        assert t1["scattered"] - t0["scattered"] == 1
        assert np.array_equal(jp.materialize("s"),
                              tp.materialize("s").numpy())
        assert jp.get("s").acc == tp.get("s").acc
        assert list(jp.get("s").blocks) == list(tp.get("s").blocks)
    finally:
        jp.close()
        tp.close()


@pytest.mark.parametrize("cuts", [(5000, 20000), (1, 4095, 8193, 30000)])
def test_host_attachment_segments_straddle_like_jax(cuts):
    """HOST bytes in segments whose boundaries fall mid-token and
    mid-layer (the adopted route, the segment walk of the fill) land
    byte-equal to the JAX load, on a fragmented pool."""
    clock = _Clock()
    opts = dict(bytes_per_token=BPT, num_blocks=16, block_tokens=8,
                use_timers=False)
    jp = jserving.PagedKvPool(jserving.KvPoolOptions(**opts), now=clock)
    tp = serving.PagedKvPool(serving.KvPoolOptions(**opts), device="cpu",
                             now=clock)
    tokens = [(3 * j + 1) % 991 for j in range(45)]
    wire = _wire(tokens).tobytes()
    try:
        # fragment both free lists the same way: two extents result
        for pool in (jp, tp):
            for k, s in enumerate(("x", "y", "z")):
                pool.load(s, np.full((16, BPT), k, np.uint8), last_token=1)
            pool.release("y")
        j0, t0 = jkv_source.kv_load_stats(), kv_source.kv_load_stats()
        bounds = [0, *cuts, len(wire)]
        jatt, tatt = JaxIOBuf(), IOBuf()
        for a, b in zip(bounds, bounds[1:]):
            jatt.append(wire[a:b])
            tatt.append(wire[a:b])
        for mod, pool, att in ((jserving, jp, jatt), (serving, tp, tatt)):
            mod.load_wire_attachment(pool, att, "s", len(tokens),
                                     jmodel.KV_LAYERS, jmodel.KV_DMODEL,
                                     last_token=tokens[-1])
        j1, t1 = jkv_source.kv_load_stats(), kv_source.kv_load_stats()
        for k in ("adopted", "scattered", "copy_bytes"):
            assert j1[k] - j0[k] == t1[k] - t0[k], k
        assert t1["adopted"] - t0["adopted"] == 1
        assert not tp.get("s").contiguous
        assert np.array_equal(jp.materialize("s"),
                              tp.materialize("s").numpy())
        assert jp.get("s").acc == tp.get("s").acc
    finally:
        jp.close()
        tp.close()


def test_load_route_consults_plane_health_like_jax():
    """With the carrying fabric socket given, the adopt-or-scatter label
    comes from the shared route table on both packages: every descriptor
    plane down records SCATTERED, a healthy plane (or no socket) ADOPTED,
    and DEVICE bytes scatter whatever the planes say."""
    import jax.numpy as jnp
    from brpc_tpu.ici import fabric as _jfabric  # noqa: F401  (flags)
    from brpc_tpu.ici import route as jroute
    from brpc_tpu_torch.ici import fabric as _tfabric  # noqa: F401
    from brpc_tpu_torch.ici import route as troute

    class _Sock:
        def __init__(self, up):
            self.up = up

        def plane_usable(self, plane, nbytes=0):
            return self.up

        def dplane_eligible(self, nbytes):
            return False

    # above ici_fabric_bulk_host_min (64 KiB), where the planes count
    big = bytes(128 * 1024)
    layers, dmodel = 4, 64
    seq = len(big) // (layers * dmodel)

    def labels(mod, buf_cls, dev_buf):
        def host():
            b = buf_cls()
            b.append_user_data(memoryview(big))
            return b
        return (mod.wire_source(host(), layers, seq, dmodel).route,
                mod.wire_source(host(), layers, seq, dmodel,
                                sock=_Sock(True)).route,
                mod.wire_source(host(), layers, seq, dmodel,
                                sock=_Sock(False)).route,
                mod.wire_source(dev_buf(), layers, seq, dmodel,
                                sock=_Sock(True)).route)

    def jdev():
        b = JaxIOBuf()
        b.append_device_array(jnp.zeros(len(big), jnp.uint8))
        return b

    def tdev():
        b = IOBuf()
        b.append_device_array(torch.zeros(len(big), dtype=torch.uint8))
        return b

    got = labels(kv_source, IOBuf, tdev)
    assert got == labels(jkv_source, JaxIOBuf, jdev)
    assert got == (kv_source.ADOPTED, kv_source.ADOPTED,
                   kv_source.SCATTERED, kv_source.SCATTERED)
    for route, sock in ((troute, _Sock(True)), (jroute, _Sock(True))):
        assert route.SHM in route.candidates(sock, route.HOST, len(big))
    assert troute.candidates(_Sock(False), troute.HOST, len(big)) \
        == jroute.candidates(_Sock(False), jroute.HOST, len(big)) \
        == [troute.INLINE]


def test_rpc_routes_and_custody_drain_on_three_planes():
    """The DecodeService's LoadKv over the loopback plane (a DEVICE
    block: scattered), over the native ici:// door (the parked handle
    taken through take_segments: scattered) and with serving_kv_adopt
    off (materialized, three passes): every decode equals the JAX
    model's reference_generate, and the device-ref registry and the
    native attachment table are empty after each."""
    import gc
    from brpc_tpu_torch.butil import flags as tflags
    from brpc_tpu_torch.examples.disagg_serving import model as tmodel
    from brpc_tpu_torch.examples.disagg_serving.workers import \
        DecodeService
    from brpc_tpu_torch.ici import native_plane as npl
    from brpc_tpu_torch.ici.mesh import IciMesh
    tokens = [(17 * j) % 499 for j in range(40)]
    want = jmodel.reference_generate(tokens, 9)
    nbytes = len(tokens) * BPT
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    parked = []
    real_take = npl.NativeAttachment.take_segments

    def take(self):
        parked.append(len(self))
        return real_take(self)

    def load(ch, session):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(
            mesh.own(tmodel.toy_kv_blocks(tokens, "cpu"), 1))
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": session,
                                "seq_len": len(tokens),
                                "last_token": tokens[-1]})), EchoResponse)
        assert not cntl.failed(), cntl.error_text

    def decode(ch, session):
        cntl = rpc.Controller()
        resp = ch.call_method("Decode.Decode", cntl, EchoRequest(
            message=json.dumps({"session": session, "steps": 9,
                                "mode": "sync"})), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        return json.loads(resp.message)["tokens"]

    npl.NativeAttachment.take_segments = take
    try:
        for plane, addr in (("loopback", "mem://kv-route"),
                            ("ici", "ici://5")):
            server = rpc.Server()
            svc = DecodeService(5, mesh=mesh,
                                pool_options=serving.KvPoolOptions(
                                    bytes_per_token=BPT, num_blocks=32,
                                    block_tokens=16))
            server.add_service(svc)
            assert server.start(addr) == 0
            ch = rpc.Channel()
            ch.init(addr, options=rpc.ChannelOptions(timeout_ms=30000))
            try:
                parked.clear()
                s0 = kv_source.kv_load_stats()
                load(ch, "r1")
                assert decode(ch, "r1") == want, plane
                s1 = kv_source.kv_load_stats()
                assert s1["scattered"] - s0["scattered"] == 1, plane
                assert s1["materialized"] == s0["materialized"], plane
                assert s1["copy_bytes"] - s0["copy_bytes"] == nbytes
                # the native door hands the handler a parked handle
                assert parked == ([nbytes] if plane == "ici" else []), \
                    plane
                tflags.set_flag("serving_kv_adopt", False)
                try:
                    load(ch, "r2")
                finally:
                    tflags.set_flag("serving_kv_adopt", True)
                assert decode(ch, "r2") == want, plane
                s2 = kv_source.kv_load_stats()
                assert s2["materialized"] - s1["materialized"] == 1
                assert s2["copy_bytes"] - s1["copy_bytes"] == 3 * nbytes
                gc.collect()
                assert npl.registry().live() == 0, plane
                assert npl.att_table_live() == 0, plane
                assert svc.describe_serving()["kv_load"]["scattered"] >= 1
            finally:
                ch.close()
                svc.close()
                server.stop()
                server.join()
    finally:
        npl.NativeAttachment.take_segments = real_take
        IciMesh.set_default(None)


def test_wire_source_is_single_use_and_checks_size():
    pool = serving.PagedKvPool(serving.KvPoolOptions(
        bytes_per_token=BPT, num_blocks=8, block_tokens=8,
        use_timers=False), device="cpu")
    try:
        att = IOBuf()
        att.append_device_array(torch.zeros(BPT * 5, dtype=torch.uint8))
        with pytest.raises(ValueError, match="descriptor said"):
            serving.load_wire_attachment(pool, att, "s", 6, jmodel.KV_LAYERS,
                                         jmodel.KV_DMODEL, last_token=0)
        src = serving.wire_source(att, jmodel.KV_LAYERS, 5, jmodel.KV_DMODEL)
        src.release()
        with pytest.raises(RuntimeError, match="single-use"):
            pool.load_into("s", 5, src.fill, last_token=0)
        assert pool.describe()["fill_aborts"] == 1
        assert pool.describe()["blocks_free"] == 8
    finally:
        pool.close()


def test_router_feedback_collapses_a_failing_target_like_jax():
    urls = ["ici://2", "ici://3"]
    jr = jserving.LoadAwareRouter(urls)
    tr = serving.LoadAwareRouter(urls, rng=random.Random(5))
    try:
        for r in (jr, tr):
            for _ in range(10):
                r.feedback("ici://2", rpc.errors.EFAILEDSOCKET, 2000)
                r.feedback("ici://3", 0, 2000)
        assert jr.describe()["weights"] == tr.describe()["weights"]
        assert tr.weight_of("ici://2") < tr.weight_of("ici://3") / 50
        picks = [tr.pick() for _ in range(200)]
        for url in picks:
            tr.feedback(url, 0, 2000)
        assert picks.count("ici://3") > 180
        assert tr.pick(exclude={"ici://3"}) == "ici://2"
        assert tr.describe()["picks"]["ici://3"] == picks.count("ici://3")
    finally:
        jr.close()
        tr.close()


class _Context(rpc.Service):
    SERVICE_NAME = "Ctx"

    @rpc.method(EchoRequest, EchoResponse)
    def Read(self, cntl, request, response, done):
        response.message = json.dumps({
            "priority": cntl.priority, "tenant": cntl.tenant,
            "deadline_left_ms": cntl.deadline_left_ms})
        done()

    @rpc.method(EchoRequest, EchoResponse)
    def Shed(self, cntl, request, response, done):
        # completes later, from another thread
        def later():
            cntl.retry_after_ms = 25
            cntl.set_failed(rpc.errors.ELIMIT, "shed")
            done()
            done()                   # a second call is a no-op
        threading.Timer(0.01, later).start()

    @rpc.method(EchoRequest, EchoResponse)
    def Boom(self, cntl, request, response, done):
        if request.message == "after":
            response.message = "answered"
            done()
        raise RuntimeError("handler bug")


def test_request_context_crosses_the_wire_both_ways():
    server = rpc.Server()
    server.add_service(_Context())
    assert server.start("mem://ctx-port") == 0
    ch = rpc.Channel()
    ch.init("mem://ctx-port", options=rpc.ChannelOptions(timeout_ms=5000,
                                                 max_retry=0))
    try:
        cntl = rpc.Controller()
        cntl.priority, cntl.tenant = 0, "gold"
        resp = ch.call_method("Ctx.Read", cntl, EchoRequest(message="r"),
                              EchoResponse)
        assert not cntl.failed(), cntl.error_text
        got = json.loads(resp.message)
        assert got["priority"] == 0 and got["tenant"] == "gold"
        assert 0 < got["deadline_left_ms"] <= 5000
        cntl = rpc.Controller()
        resp = ch.call_method("Ctx.Read", cntl, EchoRequest(message="r"),
                              EchoResponse)
        assert json.loads(resp.message)["priority"] is None
        for _ in range(3):
            cntl = rpc.Controller()
            ch.call_method("Ctx.Shed", cntl, EchoRequest(message="s"),
                           EchoResponse)
            assert cntl.error_code == rpc.errors.ELIMIT
            assert cntl.retry_after_ms == 25
        # a handler that raises answers EINTERNAL, once; one that raises
        # after answering keeps its answer
        cntl = rpc.Controller()
        ch.call_method("Ctx.Boom", cntl, EchoRequest(message="before"),
                       EchoResponse)
        assert cntl.error_code == rpc.errors.EINTERNAL
        assert "handler bug" in cntl.error_text
        cntl = rpc.Controller()
        resp = ch.call_method("Ctx.Boom", cntl, EchoRequest(message="after"),
                              EchoResponse)
        assert not cntl.failed() and resp.message == "answered"
    finally:
        ch.close()
        server.stop()


# the port's twin of tests/test_serving.py's two-process shm claim: process
# 1's KV crosses as host bytes on the fabric's shm ring and its zero-copy
# claim lands in process 0's pool (adopted); one DEVICE session crosses on
# the device plane and scatters.  Nothing materializes, and every decode
# equals the reference.
_KV_SHM_BODY = r"""
from brpc_tpu_torch.examples.disagg_serving import model as m
from brpc_tpu_torch.ici.route import route_stats
SEQ, STEPS, N = 512, 7, 4
PAYLOAD = m.kv_nbytes(SEQ)
if pid == 0:
    from brpc_tpu_torch.serving import KvPoolOptions, kv_load_stats
    from brpc_tpu_torch.examples.disagg_serving.workers import DecodeService
    server = rpc.Server()
    svc = DecodeService(0, mesh=mesh, pool_options=KvPoolOptions(
        bytes_per_token=m.KV_LAYERS * m.KV_DMODEL, num_blocks=256,
        block_tokens=16, use_timers=False))
    server.add_service(svc)
    assert server.start("ici://0") == 0
    put("kvshm/up", 1)
    # read the socket while the client still holds its channel: once it
    # closes, this end's ring is let go with the connection
    get("kvshm/sent")
    socks = fabric_socks()
    st = kv_load_stats()
    result({"shm_bound": bool(socks) and socks[0].shm_bound(),
            "claimed": socks[0].shm_bytes_claimed if socks else 0,
            "stats": st, "served": svc.describe_serving()["kv_load"],
            "foreign": foreign()})
    barrier("kvshm/done")
    svc.close(); server.stop()
else:
    get("kvshm/up")
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=120000,
                                                  max_retry=0))
    decodes = []
    for i in range(N + 1):
        tokens = [(11 * i + j) % 997 for j in range(SEQ)]
        payload = m.toy_kv_blocks(tokens, "cpu")
        cntl = rpc.Controller()
        if i < N:
            cntl.request_attachment.append(payload.numpy().tobytes())
        else:
            cntl.request_attachment.append_device_array(
                mesh.own(payload, 2))
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": "s%d" % i, "seq_len": SEQ,
                                "last_token": tokens[-1]})), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        dc = rpc.Controller()
        resp = ch.call_method("Decode.Decode", dc, EchoRequest(
            message=json.dumps({"session": "s%d" % i, "steps": STEPS,
                                "mode": "sync"})), EchoResponse)
        assert not dc.failed(), dc.error_text
        decodes.append([tokens, json.loads(resp.message)["tokens"]])
    put("kvshm/sent", 1)
    s = fabric_socks()[0]
    rs = route_stats()
    result({"shm_bound": s.shm_bound(), "sent": s.shm_bytes_sent,
            "shm_route_bytes": rs.get("shm_bytes", 0),
            "decodes": decodes, "foreign": foreign()})
    barrier("kvshm/done")
    ch.close()
finish()
"""


def test_kv_shm_claim_lands_in_pool_2proc():
    from tests.torch_procs import ok, run_procs
    srv, cli = ok(run_procs(_KV_SHM_BODY, 2, timeout=120))
    payload = jmodel.kv_nbytes(512)
    assert srv["foreign"] == cli["foreign"] == []
    assert srv["shm_bound"] and cli["shm_bound"]
    assert srv["claimed"] >= 4 * payload
    assert cli["sent"] >= 4 * payload
    assert cli["shm_route_bytes"] >= 4 * payload
    st = srv["stats"]
    assert (st["adopted"], st["scattered"], st["materialized"]) == (4, 1, 0)
    assert st["copy_bytes"] == (st["adopted"] + st["scattered"]) * payload
    assert srv["served"]["adopted"] == 4
    for tokens, got in cli["decodes"]:
        assert got == jmodel.reference_generate(tokens, 7)
