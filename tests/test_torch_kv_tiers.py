"""The KV pool's host tier and ``write_rows`` in the port, held against the
JAX package's pool on the CPU.

Every scenario of the JAX package's ``TestKvTiers``, its two
``write_rows`` CoW tests and its restore-copy-failure regression runs on
BOTH pools — ``brpc_tpu.serving.PagedKvPool`` (numpy arenas) and
``brpc_tpu_torch.serving.PagedKvPool(device="cpu")`` — from the same
seeded rows and the same injected clock.  Each asserts the JAX test's
outcomes on both, and the two pools must then agree exactly on the block
tables, the spilled set, the free lists and the ``describe()["tiers"]``
counters.  A seeded load/pressure/restore sequence compares the same
after every operation and every session's bytes at the end.  Tolerances
are exact.
"""
import time
import types

import numpy as np
import pytest

from brpc_tpu import serving as jserving
from brpc_tpu.butil import flags as jflags
from brpc_tpu.ici import route as jroute
from brpc_tpu.serving import kv_pool as jkv_pool
from brpc_tpu_torch import serving as tserving
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.serving import kv_pool as tkv_pool
from examples.disagg_serving import model as jmodel

BPT = jmodel.KV_LAYERS * jmodel.KV_DMODEL

JAX = types.SimpleNamespace(
    name="jax", serving=jserving, flags=jflags, route=jroute,
    kv_pool=jkv_pool, np=lambda a: a,
    pool=lambda opts, now: jserving.PagedKvPool(opts, now=now))
PORT = types.SimpleNamespace(
    name="port", serving=tserving, flags=tflags, route=troute,
    kv_pool=tkv_pool, np=lambda t: t.numpy(),
    pool=lambda opts, now: tserving.PagedKvPool(opts, device="cpu", now=now))

# describe()["tiers"] keys that mean the same thing in both packages
# (restore_p50_us is a wall time; the plane row's reprobe_in is a
# countdown)
_TIER_KEYS = ("enabled", "host_blocks_total", "host_blocks_free",
              "resident_sessions", "spilled_sessions", "spilled_blocks",
              "demotions", "restores", "restore_corrupt", "host_evictions")
_PLANE_KEYS = ("state", "reason", "downs", "revivals", "half_open",
               "probe_failures")


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _rows(tokens):
    """Prompt -> token-major pool rows through the JAX model."""
    kv = np.asarray(jmodel.toy_kv_blocks(tokens))
    seq = len(tokens)
    return kv.reshape(jmodel.KV_LAYERS, seq, jmodel.KV_DMODEL).transpose(
        1, 0, 2).reshape(seq, BPT)


def _mk(pkg, clock, num_blocks=32, block_tokens=8, **kw):
    opts = pkg.serving.KvPoolOptions(
        bytes_per_token=BPT, num_blocks=num_blocks,
        block_tokens=block_tokens, use_timers=False, **kw)
    return pkg.pool(opts, clock)


def _mat(pkg, pool, session):
    got = pool.materialize(session)
    return None if got is None else pkg.np(got)


def _state(pool) -> dict:
    """What the two pools must agree on, read without restoring."""
    d = pool.describe()
    tiers = d["tiers"]
    out = {k: tiers[k] for k in _TIER_KEYS}
    if "plane" in tiers:
        out["plane"] = {k: tiers["plane"][k] for k in _PLANE_KEYS}
    out.update(
        tables={s: list(map(int, v.blocks))
                for s, v in sorted(pool._tables.items())},
        spilled={s: list(map(int, v.hblocks))
                 for s, v in sorted(pool._spilled.items())},
        free=list(pool._free), host_free=list(pool._host_free),
        refs=dict(sorted(pool._refs.items())),
        host_refs=dict(sorted(pool._host_refs.items())),
        evictions=d["evictions"], expired=d["expired"],
        by_tenant=d["by_tenant"])
    return out


def _both(scenario, **pool_kw):
    """Run ``scenario(pkg, pool, clock)`` on the JAX pool and on the
    port's, then hold the two end states equal."""
    states = []
    for pkg in (JAX, PORT):
        clock = _Clock()
        pool = _mk(pkg, clock, **pool_kw)
        try:
            scenario(pkg, pool, clock)
            states.append(_state(pool))
        finally:
            pool.close()
    assert states[0] == states[1]


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    for fl in (jflags, tflags):
        fl.set_flag("serving_kv_spill_reprobe_s", 0.25)


def test_pressure_demotes_and_restore_is_byte_exact():
    def scenario(pkg, pool, clock):
        ta = [(3 * j) % 499 for j in range(16)]
        tb = [(5 * j + 1) % 499 for j in range(16)]
        pool.load("a", _rows(ta), last_token=ta[-1])
        clock.t += 1
        pool.load("b", _rows(tb), last_token=tb[-1])
        clock.t += 1
        tc = [(7 * j + 2) % 499 for j in range(16)]
        pool.load("c", _rows(tc), last_token=tc[-1])
        assert pool.spilled_sessions() == ["a"]
        assert pool.evicted_reason("a") == "spilled"
        d = pool.describe()["tiers"]
        assert d["demotions"] == 1 and d["spilled_sessions"] == 1
        assert d["spilled_blocks"] == 2 and d["host_blocks_free"] == 6
        assert np.array_equal(_mat(pkg, pool, "a"), _rows(ta))
        assert "a" not in pool.spilled_sessions()
        d = pool.describe()["tiers"]
        assert d["restores"] == 1 and d["restore_p50_us"] > 0
        assert d["plane"]["state"] == "up"
        assert pool.evictions.get_value() == 0
        for name, toks in (("a", ta), ("b", tb), ("c", tc)):
            assert np.array_equal(_mat(pkg, pool, name), _rows(toks)), name
    _both(scenario, num_blocks=4, host_blocks=8)


def test_host_blocks_zero_is_the_eviction_pool():
    """The JAX package's spill-off A/B leg: with no host arena, pressure
    evicts exactly as before (the port's case of the unported flag)."""
    def scenario(pkg, pool, clock):
        pool.load("a", _rows([3] * 16), last_token=3)
        clock.t += 1
        pool.load("b", _rows([5] * 16), last_token=5)
        assert pool.spilled_sessions() == []
        assert pool.get("a") is None
        assert pool.evicted_reason("a") == "pressure"
        assert pool.describe()["tiers"]["enabled"] is False
    _both(scenario, num_blocks=2, host_blocks=0)


def test_corrupt_host_copy_degrades_to_reprefill():
    def scenario(pkg, pool, clock):
        ta = [(3 * j) % 499 for j in range(16)]
        pool.load("a", _rows(ta), last_token=ta[-1])
        clock.t += 1
        pool.load("b", _rows([5] * 16), last_token=5)   # spills a
        assert pool.spilled_sessions() == ["a"]
        hb = int(pool._spilled["a"].hblocks[0])
        pool._host_store[hb, 7] ^= 0xFF                 # flip a byte
        assert pool.get("a") is None
        assert pool.materialize("a") is None
        assert pool.evicted_reason("a") == "corrupt"
        # the restore's own reservation demoted "b" first
        assert pool.spilled_sessions() == ["b"]
        d = pool.describe()["tiers"]
        assert d["restore_corrupt"] == 1 and d["restores"] == 0
        assert d["plane"]["state"] == "up"
        assert d["host_blocks_free"] == 2
        assert np.array_equal(_mat(pkg, pool, "b"), _rows([5] * 16))
        assert pool.describe()["tiers"]["host_blocks_free"] == 4
    _both(scenario, num_blocks=2, host_blocks=4)


def test_shared_prefix_spills_once_restores_n():
    def scenario(pkg, pool, clock):
        toks = [(3 * j) % 499 for j in range(16)]   # 2 full blocks
        pool.load("a", _rows(toks), last_token=toks[-1])
        pool.load("b", _rows(toks), last_token=toks[-1])
        assert pool.describe()["prefix"]["shared_blocks"] == 2
        assert pool.spill("a") and pool.spill("b")
        d = pool.describe()["tiers"]
        assert d["spilled_sessions"] == 2
        assert d["host_blocks_free"] == 2 and d["spilled_blocks"] == 2
        assert all(r == 2 for r in pool._host_refs.values())
        assert np.array_equal(_mat(pkg, pool, "a"), _rows(toks))
        assert np.array_equal(_mat(pkg, pool, "b"), _rows(toks))
        sa, sb = pool.get("a"), pool.get("b")
        assert np.array_equal(sa.blocks, sb.blocks)
        assert all(pool._refs[int(x)] == 2 for x in sa.blocks)
        d = pool.describe()["tiers"]
        assert d["restores"] == 2 and d["spilled_sessions"] == 0
        assert d["host_blocks_free"] == 4 and not pool._host_refs
    _both(scenario, num_blocks=8, host_blocks=4)


def test_pinned_session_refuses_spill():
    def scenario(pkg, pool, clock):
        pool.load("a", _rows([3] * 16), last_token=3)
        assert pool.pin("a")
        with pytest.raises(pkg.serving.SessionBusy):
            pool.spill("a")
        pool.unpin("a")
        assert pool.spill("a")
        assert pool.spilled_sessions() == ["a"]
    _both(scenario, num_blocks=4, host_blocks=4)


def test_picker_prefers_whole_shared_set_over_unshared():
    def scenario(pkg, pool, clock):
        toks = [(3 * j) % 499 for j in range(16)]
        pool.load("s1", _rows(toks), last_token=toks[-1])
        clock.t += 1
        pool.load("s2", _rows(toks), last_token=toks[-1])
        clock.t += 1
        pool.load("u", _rows([7] * 16), last_token=7)
        assert len(pool._free) == 2
        victims = pool._pick_victims_locked(4, 2, spill=True)
        names = [v.session for v in victims]
        assert set(names[:2]) == {"s1", "s2"} and names[2] == "u"
        big = [(11 * j) % 499 for j in range(48)]   # 6 blocks
        pool.load("big", _rows(big), last_token=big[-1])
        assert len(pool._free) == 0
        assert set(pool.spilled_sessions()) == {"s1", "s2", "u"}
        assert np.array_equal(_mat(pkg, pool, "big"), _rows(big))
    _both(scenario, num_blocks=6, host_blocks=8)


@pytest.mark.parametrize("host_blocks", [32, 0])
def test_capacity_under_pressure_spill_retains_more(host_blocks):
    """Same arena, same loads: with a host arena every session stays
    retrievable and byte-exact; without one only what the device arena
    holds survives."""
    alive = {}

    def scenario(pkg, pool, clock):
        sessions = {}
        for i in range(16):
            toks = [(7 * i + j) % 499 for j in range(16)]
            pool.load(f"s{i}", _rows(toks), last_token=toks[-1])
            clock.t += 1
            sessions[f"s{i}"] = toks
        live = 0
        for name, toks in sessions.items():
            got = _mat(pkg, pool, name)
            if got is not None:
                assert np.array_equal(got, _rows(toks)), name
                live += 1
        alive[pkg.name] = live
    _both(scenario, num_blocks=8, host_blocks=host_blocks)
    assert alive["jax"] == alive["port"] == (16 if host_blocks else 4)


def test_spill_plane_faults_latch_and_revive():
    deltas = {}

    def scenario(pkg, pool, clock):
        pkg.flags.set_flag("serving_kv_spill_reprobe_s", 0.1)
        before = pkg.route.plane_stats()
        pool.inject_spill_fault("demote")
        pool.load("a", _rows([3] * 16), last_token=3)
        clock.t += 1
        pool.load("b", _rows([5] * 16), last_token=5)   # pressure
        assert pool.spilled_sessions() == []
        assert pool.evicted_reason("a") == "pressure"
        d = pool.describe()["tiers"]
        assert d["plane"]["state"] == "down"
        assert d["plane"]["reason"] == "demote_io"
        pool.inject_spill_fault(None)
        clock.t += 1
        pool.load("c", _rows([7] * 16), last_token=7)   # still latched
        assert pool.spilled_sessions() == []
        time.sleep(0.15)                                # the latch lapses
        clock.t += 1
        pool.load("e", _rows([11] * 16), last_token=11)
        assert pool.spilled_sessions() == ["c"]
        after = pkg.route.plane_stats()
        deltas[pkg.name] = {e: after.get(f"spill_{e}", 0)
                            - before.get(f"spill_{e}", 0)
                            for e in ("down", "reprobe", "revived", "ramp")}
        assert pool.describe()["tiers"]["plane"]["state"] == "up"
    _both(scenario, num_blocks=2, host_blocks=8)
    assert deltas["jax"] == deltas["port"]
    assert deltas["port"]["down"] == 1 and deltas["port"]["revived"] == 1


def test_restore_io_fault_keeps_host_copy_and_sheds():
    def scenario(pkg, pool, clock):
        pkg.flags.set_flag("serving_kv_spill_reprobe_s", 0.05)
        ta = [(3 * j) % 499 for j in range(16)]
        pool.load("a", _rows(ta), last_token=ta[-1])
        assert pool.spill("a")
        pool.inject_spill_fault("restore")
        assert pool.get("a") is None                    # shed, not corrupt
        assert pool.spilled_sessions() == ["a"]
        assert pool.describe()["tiers"]["plane"]["reason"] == "restore_io"
        pool.inject_spill_fault(None)
        time.sleep(0.1)
        assert np.array_equal(_mat(pkg, pool, "a"), _rows(ta))
    _both(scenario, num_blocks=2, host_blocks=8)


def test_restore_saturated_stays_spilled():
    def scenario(pkg, pool, clock):
        ta = [(3 * j) % 499 for j in range(16)]
        pool.load("a", _rows(ta), last_token=ta[-1])
        assert pool.spill("a")
        pool.load("b", _rows([5] * 16), last_token=5)
        assert pool.pin("b")                            # arena fenced
        assert pool.get("a") is None
        assert pool.spilled_sessions() == ["a"]
        assert pool.evicted_reason("a") == "spilled"
        pool.unpin("b")
        assert np.array_equal(_mat(pkg, pool, "a"), _rows(ta))
    _both(scenario, num_blocks=2, host_blocks=8)


def test_host_arena_reclaim_drops_oldest_spilled():
    def scenario(pkg, pool, clock):
        ta = [(3 * j) % 499 for j in range(16)]
        pool.load("a", _rows(ta), last_token=ta[-1])
        clock.t += 1
        pool.load("b", _rows([5] * 16), last_token=5)   # spills a
        assert pool.spilled_sessions() == ["a"]
        clock.t += 1
        pool.load("c", _rows([7] * 16), last_token=7)   # spills b
        assert pool.spilled_sessions() == ["b"]
        assert pool.evicted_reason("a") == "pressure"
        d = pool.describe()["tiers"]
        assert d["host_evictions"] == 1 and d["demotions"] == 2
        assert np.array_equal(_mat(pkg, pool, "b"), _rows([5] * 16))
    _both(scenario, num_blocks=2, host_blocks=2)


def test_release_of_spilled_session_frees_host_blocks():
    def scenario(pkg, pool, clock):
        pool.load("a", _rows([3] * 16), last_token=3)
        assert pool.spill("a")
        assert pool.release("a")
        assert pool.spilled_sessions() == []
        assert pool.describe()["tiers"]["host_blocks_free"] == 4
        assert not pool.release("a")
    _both(scenario, num_blocks=2, host_blocks=4)


def test_spilled_session_expires_on_ttl():
    def scenario(pkg, pool, clock):
        pool.load("a", _rows([3] * 16), last_token=3)
        assert pool.spill("a")
        clock.t += 10
        pool.touch("a")                 # keep-alive reaches the host tier
        assert pool.expire_idle(now=clock.t + 6) == 0
        assert pool.spilled_sessions() == ["a"]
        assert pool.expire_idle(now=clock.t + 20) == 1
        assert pool.evicted_reason("a") == "expired"
    _both(scenario, num_blocks=2, host_blocks=4, ttl_s=15.0)


def test_scheduler_decodes_through_restored_session():
    """A spilled session submitted to the scheduler restores at the
    roster add and decodes bit-exact against the never-spilled
    reference."""
    toks = [(3 * j) % 499 for j in range(16)]
    want = jmodel.reference_generate(toks, 6)

    def scenario(pkg, pool, clock):
        sched = pkg.serving.ContinuousBatchScheduler(
            pool, pkg.serving.BatchSchedulerOptions(
                vocab=jmodel.VOCAB, max_batch=4, auto_start=False))
        out = {}
        try:
            pool.load("a", _rows(toks), last_token=toks[-1])
            assert pool.spill("a")
            sched.submit(pkg.serving.StepRequest(
                "a", 6, lambda t: out.setdefault("tokens", list(t)),
                lambda *e: out.setdefault("error", e)))
            for _ in range(10):
                sched.step_once()
                if out:
                    break
            assert out.get("tokens") == want, out
            assert pool.describe()["tiers"]["restores"] == 1
        finally:
            sched.stop()
    _both(scenario, num_blocks=8, host_blocks=8)


def test_write_rows_never_evicts_writing_session():
    """A CoW split that needs a free block never evicts the session it
    writes; when the eviction takes the block's last co-owner, the
    re-check writes in place instead of stranding the block."""
    def scenario(pkg, pool, clock):
        shared = [(9 * j) % 499 for j in range(16)]     # 2 full blocks
        other = [(2 * j + 1) % 499 for j in range(16)]
        pool.load("a", _rows(shared), last_token=shared[-1])
        clock.t += 1
        pool.load("b", _rows(shared), last_token=shared[-1])
        clock.t += 1
        pool.load("c", _rows(other), last_token=other[-1])
        assert not pool._free
        splits0 = pool.cow_splits.get_value()
        new_row = np.full((1, BPT), 7, np.uint8)
        assert pool.write_rows("a", 0, new_row) == 0
        s = pool.get("a")
        assert s is not None, "writer evicted itself"
        got = _mat(pkg, pool, "a")
        assert np.array_equal(got[0], new_row[0])
        assert np.array_equal(got[1:], _rows(shared)[1:])
        assert pool.cow_splits.get_value() == splits0
        assert pool.get("b") is None
        assert all(pool._refs[int(x)] == 1 for x in s.blocks)
        assert len(pool._free) + len(pool._refs) == 4
        # the write moved the session's accumulator by the bytes' delta
        assert s.acc == int(got.astype(np.int64).sum())
        pool.release("a")
        assert len(pool._free) == 4 and not pool._refs \
            and not pool._prefix_index and not pool._block_hash
    _both(scenario, num_blocks=4, block_tokens=8)


def test_write_rows_split_after_eviction_keeps_coowner():
    def scenario(pkg, pool, clock):
        shared = [(9 * j) % 499 for j in range(16)]
        other = [(2 * j + 1) % 499 for j in range(16)]
        pool.load("a", _rows(shared), last_token=shared[-1])
        pool.load("b", _rows(shared), last_token=shared[-1])
        pool.load("c", _rows(other), last_token=other[-1])
        assert pool.pin("a")
        splits0 = pool.cow_splits.get_value()
        new_row = np.full((1, BPT), 7, np.uint8)
        assert pool.write_rows("b", 0, new_row) == 1
        assert pool.cow_splits.get_value() == splits0 + 1
        assert pool.get("c") is None
        assert np.array_equal(_mat(pkg, pool, "a"), _rows(shared))
        got = _mat(pkg, pool, "b")
        assert np.array_equal(got[0], new_row[0])
        assert np.array_equal(got[1:], _rows(shared)[1:])
        assert int(pool.get("b").blocks[0]) != int(pool.get("a").blocks[0])
        pool.unpin("a")
        pool.release("a")
        pool.release("b")
        assert len(pool._free) == 4 and not pool._refs
    _both(scenario, num_blocks=4, block_tokens=8)


def test_restore_copy_failure_releases_reservation_and_host_refs(
        monkeypatch):
    """The copy outside the lock raises: the reservation returns, the
    session stays spilled with its host refs, the exception propagates,
    and the next lookup restores byte-exact."""
    def scenario(pkg, pool, clock):
        toks = [(3 * j) % 499 for j in range(16)]
        pool.load("a", _rows(toks), last_token=toks[-1])
        assert pool.spill("a")
        free0 = len(pool._free)
        refs0 = dict(pool._host_refs)
        real = pkg.kv_pool.zlib.crc32

        def boom(data, chain=0):
            raise MemoryError("copy failed mid-restore")

        monkeypatch.setattr(pkg.kv_pool.zlib, "crc32", boom)
        with pytest.raises(MemoryError):
            pool.get("a")
        monkeypatch.setattr(pkg.kv_pool.zlib, "crc32", real)
        assert len(pool._free) == free0
        assert pool.spilled_sessions() == ["a"]
        assert pool._host_refs == refs0 and not pool._restoring
        assert np.array_equal(_mat(pkg, pool, "a"), _rows(toks))
        assert pool.describe()["tiers"]["restores"] == 1
    _both(scenario, num_blocks=4, host_blocks=4)


def _seeded_ops(rng):
    """Loads with shared prefixes under pressure on a small arena with a
    smaller host tier, explicit spills, restores by every touch surface,
    in-place writes, releases and expiry."""
    def toks(n):
        return rng.integers(0, jmodel.VOCAB, n).tolist()

    base = toks(48)
    ops = []
    names = [f"s{i}" for i in range(10)]
    for i, name in enumerate(names):
        n = int(rng.integers(6, 40))
        t = base[:n] if i % 3 == 0 else toks(n)
        ops.append(("load", name, t, int(rng.integers(0, 4)),
                    ("gold", "bronze", "")[i % 3]))
        ops.append(("tick",))
        kind = rng.integers(0, 6)
        other = names[int(rng.integers(0, i + 1))]
        if kind == 0:
            ops.append(("spill", other))
        elif kind == 1:
            ops.append(("get", other))
        elif kind == 2:
            ops.append(("pin_unpin", other))
        elif kind == 3:
            ops.append(("write", other, int(rng.integers(0, 256))))
        elif kind == 4:
            ops.append(("release", other))
        else:
            ops.append(("touch", other))
    ops.append(("expire",))
    return ops


def _apply(pkg, pool, clock, op):
    """One operation; returns its outcome (an exception's type name)."""
    kind, args = op[0], op[1:]
    try:
        if kind == "load":
            name, t, pri, tenant = args
            return int(pool.load(name, _rows(t), last_token=t[-1],
                                 tenant=tenant, priority=pri).acc)
        if kind == "tick":
            clock.t += 1
            return None
        if kind == "spill":
            return pool.spill(args[0])
        if kind == "get":
            s = pool.get(args[0])
            return None if s is None else (s.seq_len, s.acc, s.last_token)
        if kind == "pin_unpin":
            ok = pool.pin(args[0])
            if ok:
                pool.unpin(args[0])
            return ok
        if kind == "write":
            s = pool.get(args[0])
            if s is None:
                return None
            row = np.full((1, BPT), args[1], np.uint8)
            return pool.write_rows(args[0], s.seq_len - 1, row)
        if kind == "release":
            return pool.release(args[0])
        if kind == "touch":
            return pool.touch(args[0])
        if kind == "expire":
            return pool.expire_idle(now=clock.t + 12)
        raise AssertionError(kind)
    except (jserving.PoolSaturated, jserving.SessionBusy,
            tserving.PoolSaturated, tserving.SessionBusy) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sequence_matches_jax(seed):
    """The same seeded operations on both pools: equal outcomes, equal
    tables, spilled sets, free lists and tier counters after every
    operation, and equal bytes for every session at the end."""
    ops = _seeded_ops(np.random.default_rng(seed))
    clocks = [_Clock(), _Clock()]
    pools = [_mk(pkg, c, num_blocks=12, block_tokens=8, host_blocks=6,
                 ttl_s=20.0, tenant_weights={"gold": 4, "bronze": 1})
             for pkg, c in zip((JAX, PORT), clocks)]
    try:
        for op in ops:
            outs = [_apply(pkg, p, c, op)
                    for pkg, p, c in zip((JAX, PORT), pools, clocks)]
            assert outs[0] == outs[1], op
            assert _state(pools[0]) == _state(pools[1]), op
        names = {op[1] for op in ops if op[0] == "load"}
        for name in sorted(names):
            a, b = (_mat(pkg, p, name) for pkg, p in zip((JAX, PORT), pools))
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.array_equal(a, b), name
            assert pools[0].evicted_reason(name) == \
                pools[1].evicted_reason(name), name
        assert _state(pools[0]) == _state(pools[1])
        tiers = pools[1].describe()["tiers"]
        assert tiers["demotions"] > 0 and tiers["restores"] > 0
    finally:
        for p in pools:
            p.close()
