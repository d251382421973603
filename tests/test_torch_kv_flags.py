"""The KV pool's three A/B flags in the port, held against the JAX
package's pool on the CPU.

``serving_kv_prefix_share``, ``serving_kv_concurrent_fill`` and
``serving_kv_spill`` are defined in each package's own ``butil.flags``.
Every JAX test of them in ``tests/test_serving.py`` (the prefix-share
capacity A/B, the two fill-discipline tests, the spill-off eviction and
the spill capacity A/B) runs here on BOTH pools,
``brpc_tpu.serving.PagedKvPool`` and
``brpc_tpu_torch.serving.PagedKvPool(device="cpu")``, with the same
seeded rows and an injected clock, under both settings of its flag.  Each
asserts the JAX test's outcomes on both pools, and the two must then
agree exactly on the block tables, the free lists, the refcounts, the
spilled set, ``describe()`` and every session's bytes.  Tolerances are
exact.
"""
import threading
import types

import numpy as np
import pytest
import torch

from brpc_tpu import serving as jserving
from brpc_tpu.butil import flags as jflags
from brpc_tpu_torch import serving as tserving
from brpc_tpu_torch.butil import flags as tflags

BPT = 64                      # bytes per token row
VOCAB = 499
# one seeded row per token id: sessions that share a token prefix share
# its rows, which is what the prefix index keys on
_TABLE = np.random.default_rng(20).integers(0, 256, (VOCAB, BPT),
                                            dtype=np.uint8)

JAX = types.SimpleNamespace(
    name="jax", serving=jserving, flags=jflags,
    np=lambda a: a, copy=lambda v, rows: v.__setitem__(slice(None), rows),
    pool=lambda opts, now: jserving.PagedKvPool(opts, now=now))
PORT = types.SimpleNamespace(
    name="port", serving=tserving, flags=tflags,
    np=lambda t: t.numpy(),
    copy=lambda v, rows: v.copy_(torch.as_tensor(rows)),
    pool=lambda opts, now: tserving.PagedKvPool(opts, device="cpu",
                                                now=now))
PKGS = (JAX, PORT)

_FLAGS = ("serving_kv_prefix_share", "serving_kv_concurrent_fill",
          "serving_kv_spill")
# describe() keys that mean the same thing in both packages
_TOP_KEYS = ("blocks_total", "blocks_free", "blocks_used", "sessions",
             "pinned", "blocks_by_tenant", "loads", "bytes_in",
             "evictions", "expired", "fill_aborts", "by_tenant")
_PREFIX_KEYS = ("enabled", "concurrent_fill", "shared_blocks",
                "prefix_hits", "cow_splits", "commit_races",
                "locked_fills", "unlocked_fills", "logical_blocks",
                "physical_blocks", "sharing_ratio")
_TIER_KEYS = ("enabled", "host_blocks_total", "host_blocks_free",
              "resident_sessions", "spilled_sessions", "spilled_blocks",
              "demotions", "restores", "restore_corrupt", "host_evictions")


def _rows(tokens):
    return _TABLE[np.asarray(tokens, np.int64)]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        self.t += 0.001          # every read moves: LRU order is exact
        return self.t


def _mk(pkg, num_blocks=32, block_tokens=8, **kw):
    opts = pkg.serving.KvPoolOptions(
        bytes_per_token=BPT, num_blocks=num_blocks,
        block_tokens=block_tokens, ttl_s=120.0, use_timers=False, **kw)
    return pkg.pool(opts, _Clock())


@pytest.fixture(autouse=True)
def _flags_back():
    """Every flag back on after each test, in both packages."""
    yield
    for name in _FLAGS:
        jflags.set_flag(name, True)
        tflags.set_flag(name, True)


def _set(name, value):
    jflags.set_flag(name, value)
    tflags.set_flag(name, value)


def _state(pkg, pool):
    """Everything the two pools must agree on, in plain values."""
    d = pool.describe()
    tables = {k: [int(b) for b in s.blocks]
              for k, s in sorted(pool._tables.items())}
    return {
        "tables": tables,
        "free": list(pool._free),
        "refs": dict(sorted(pool._refs.items())),
        "spilled": sorted(pool.spilled_sessions()),
        "top": {k: d[k] for k in _TOP_KEYS},
        "prefix": {k: d["prefix"][k] for k in _PREFIX_KEYS},
        "tiers": {k: d["tiers"][k] for k in _TIER_KEYS},
        "bytes": {k: pkg.np(pool.materialize(k)).tobytes()
                  for k in tables},
    }


def _agree(pools):
    (jp, tp) = pools
    assert _state(PORT, tp) == _state(JAX, jp)


# ---- serving_kv_prefix_share -----------------------------------------

def _capacity(share):
    """The JAX capacity A/B's leg (``TestKvPrefixSharing``): a 50 %-shared
    prefix mix loaded pinned to saturation, every resident session
    byte-exact; both pools hold the same tables.  Returns the count."""
    pre_a = [(7 * j) % VOCAB for j in range(96)]
    pre_b = [(11 * j + 3) % VOCAB for j in range(96)]

    def mk(i):
        pre = pre_a if i % 2 == 0 else pre_b
        return pre + [(13 * i + j + 1) % VOCAB for j in range(4)]

    _set("serving_kv_prefix_share", share)
    pools = [_mk(pkg, num_blocks=64) for pkg in PKGS]
    caps = []
    try:
        for pkg, pool in zip(PKGS, pools):
            saturated = pkg.serving.PoolSaturated
            loaded = []
            for i in range(200):
                toks = mk(i)
                try:
                    pool.load(f"cap{i}", _rows(toks), last_token=toks[-1])
                except saturated:
                    break
                assert pool.pin(f"cap{i}")
                loaded.append((f"cap{i}", toks))
            for name, toks in loaded:
                assert np.array_equal(pkg.np(pool.materialize(name)),
                                      _rows(toks)), (pkg.name, name)
            d = pool.describe()["prefix"]
            assert d["enabled"] is share
            if share:
                assert d["shared_blocks"] == 24
                assert d["sharing_ratio"] > 2.0
                assert d["prefix_hits"] > 0
            else:
                assert d["shared_blocks"] == 0
                assert d["prefix_hits"] == 0
            caps.append(len(loaded))
        assert caps[0] == caps[1]
        _agree(pools)
        # no CRC pass and no index on the private-blocks path
        crc = pools[1].describe()["prefix"]["crc_d2h_passes"]
        assert (crc > 0) is share
        assert bool(pools[1]._prefix_index) is share
    finally:
        for p in pools:
            for k in list(p._tables):
                p.unpin(k)
            p.close()
    return caps[0]


@pytest.mark.parametrize("share", [True, False])
def test_prefix_share_capacity_leg(share):
    assert _capacity(share) > 0


def test_prefix_share_capacity_ratio():
    """Sharing on fits at least 5x the sessions of sharing off, on the
    port's pool as on the JAX pool."""
    on = _capacity(True)
    off = _capacity(False)
    assert on >= 5 * off, (on, off)


def test_prefix_share_off_frees_through_refcounts():
    """With sharing off, identical sessions own private blocks; eviction,
    release and ``write_rows`` go through the same refcount code, and a
    restored session stays private."""
    _set("serving_kv_prefix_share", False)
    toks = [(5 * j + 1) % VOCAB for j in range(20)]
    pools = [_mk(pkg, num_blocks=8, host_blocks=8) for pkg in PKGS]
    try:
        for pkg, pool in zip(PKGS, pools):
            a = pool.load("a", _rows(toks), last_token=toks[-1])
            b = pool.load("b", _rows(toks), last_token=toks[-1])
            assert not set(int(x) for x in a.blocks) & \
                set(int(x) for x in b.blocks)
            assert pool.write_rows("b", 3, _rows([9, 9])) == 0
            other = [(3 * j) % VOCAB for j in range(24)]
            pool.load("c", _rows(other), last_token=other[-1])
            assert pool.spilled_sessions() == ["a"]
            assert np.array_equal(pkg.np(pool.materialize("a")),
                                  _rows(toks))
            assert pool.release("b")
        _agree(pools)
    finally:
        for p in pools:
            p.close()


# ---- serving_kv_concurrent_fill --------------------------------------

@pytest.mark.parametrize("conc", [True, False])
def test_load_and_load_into_parity_both_disciplines(conc):
    toks = [(11 * j) % VOCAB for j in range(20)]
    rows = _rows(toks)
    _set("serving_kv_concurrent_fill", conc)
    pools = [_mk(pkg, num_blocks=16) for pkg in PKGS]
    try:
        for pkg, pool in zip(PKGS, pools):
            a = pool.load("a", rows, last_token=toks[-1])

            def fill(views, pkg=pkg):
                off = 0
                for v in views:
                    pkg.copy(v, rows[off:off + v.shape[0]])
                    off += v.shape[0]

            b = pool.load_into("b", len(toks), fill, last_token=toks[-1])
            route = pool.unlocked_fills if conc else pool.locked_fills
            other = pool.locked_fills if conc else pool.unlocked_fills
            assert route.get_value() == 2
            assert other.get_value() == 0
            assert a.acc == b.acc and a.seq_len == b.seq_len
            assert np.array_equal(pkg.np(pool.materialize("a")),
                                  pkg.np(pool.materialize("b")))
            assert np.array_equal(a.blocks[:2], b.blocks[:2])
            assert pool.describe()["prefix"]["concurrent_fill"] is conc
        _agree(pools)
    finally:
        for p in pools:
            p.close()


@pytest.mark.parametrize("conc", [True, False])
def test_concurrent_fill_serializes_only_when_off(conc):
    """With the flag on a second load completes while another fill is
    parked inside the pool; off, it waits for the parked fill."""
    toks_a = [(3 * j + 1) % VOCAB for j in range(16)]
    toks_b = [(5 * j + 2) % VOCAB for j in range(16)]
    _set("serving_kv_concurrent_fill", conc)
    pools = [_mk(pkg) for pkg in PKGS]
    try:
        for pkg, pool in zip(PKGS, pools):
            in_fill = threading.Event()
            unblock = threading.Event()
            done_b = threading.Event()

            def slow_fill(views, pkg=pkg):
                rows = _rows(toks_a)
                off = 0
                for v in views:
                    pkg.copy(v, rows[off:off + v.shape[0]])
                    off += v.shape[0]
                in_fill.set()
                assert unblock.wait(10)

            ta = threading.Thread(target=lambda pool=pool: pool.load_into(
                "a", len(toks_a), slow_fill, last_token=toks_a[-1]))
            ta.start()
            try:
                assert in_fill.wait(10)
                tb = threading.Thread(target=lambda pool=pool: (
                    pool.load("b", _rows(toks_b), last_token=toks_b[-1]),
                    done_b.set()))
                tb.start()
                if conc:
                    assert done_b.wait(5), "concurrent fill serialized"
                else:
                    assert not done_b.wait(0.3), \
                        "locked fill should serialize"
            finally:
                unblock.set()
                ta.join(10)
            tb.join(10)
            assert done_b.is_set()
            assert np.array_equal(pkg.np(pool.materialize("a")),
                                  _rows(toks_a))
            assert np.array_equal(pkg.np(pool.materialize("b")),
                                  _rows(toks_b))
            d = pool.describe()["prefix"]
            assert d["unlocked_fills"] == (2 if conc else 0)
            assert d["locked_fills"] == (0 if conc else 2)
        _agree(pools)
    finally:
        for p in pools:
            p.close()


# ---- serving_kv_spill ------------------------------------------------

def test_spill_off_flag_is_the_eviction_ab():
    _set("serving_kv_spill", False)
    pools = [_mk(pkg, num_blocks=2, host_blocks=8) for pkg in PKGS]
    try:
        for pool in pools:
            pool.load("a", _rows([3] * 16), last_token=3)
            pool.load("b", _rows([5] * 16), last_token=5)
            assert pool.spilled_sessions() == []
            assert pool.get("a") is None
            assert pool.evicted_reason("a") == "pressure"
            assert pool.describe()["tiers"]["enabled"] is False
            assert pool.spill("b") is False
        _agree(pools)
    finally:
        for p in pools:
            p.close()


@pytest.mark.parametrize("spill", [True, False])
def test_capacity_under_pressure_ab(spill):
    """Same arena, same load pattern: spill on keeps all 16 sessions
    retrievable, spill off only what the card arena holds; every live
    session byte-exact and both pools alike after every load."""
    _set("serving_kv_spill", spill)
    pools = [_mk(pkg, num_blocks=8, host_blocks=32) for pkg in PKGS]
    try:
        sessions = {}
        for i in range(16):
            toks = [(7 * i + j) % VOCAB for j in range(16)]
            sessions[f"s{i}"] = toks
            for pool in pools:
                pool.load(f"s{i}", _rows(toks), last_token=toks[-1])
            _agree(pools)
        alive = []
        for pkg, pool in zip(PKGS, pools):
            live = 0
            for name, toks in sessions.items():
                got = pool.materialize(name)
                if got is not None:
                    assert np.array_equal(pkg.np(got), _rows(toks)), name
                    live += 1
            alive.append(live)
        assert alive[0] == alive[1]
        if spill:
            assert alive[1] == 16
        else:
            assert alive[1] == 4      # what 8 blocks of 2 hold
        _agree(pools)
    finally:
        for p in pools:
            p.close()


# ---- chip_smoke.py phase 24, rehearsed on the CPU ----------------------

_PHASE24_CPU = r"""
import importlib, json, os, sys
sys.path.insert(0, %(repo)r)
import chip_smoke as cs
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
cm = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
plain = [0]
inner = cm.p2p_copy_plain
def counted(src, dst):
    plain[0] += 1
    return inner(src, dst)
cm.p2p_copy_plain = counted
flags.set_flag("ici_device_plane_host_mesh", True)
mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
cs.KVF_SPILL_SEQ, cs.KVF_SPILL_BLOCKS, cs.KVF_BIG = 256, 128, 512
# a loaded CPU host: a stall long enough that a concurrent probe never
# takes half of it
cs.KVF_STALL_S = 1.0
a = cs.phase_kv_flags(mesh, device_plane.plane(), cm.p2p_copy,
                      device="cpu", launches=lambda: plain[0])
a["plain_copies"] = plain[0]
b = cs.phase_protocols(calls=3, kv_ops=64)
foreign = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                 or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
print("RESULT " + json.dumps({"a": a, "b": b, "foreign": foreign}),
      flush=True)
"""


def test_phase24_rehearsal_on_cpu():
    """Phase 24 on a CPU mesh at a small size, its own checks held: the
    capacity ratio, the parked fill, spilled against evicted, LoadKv
    relocations = plain copies, and every protocol on one port."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c",
                           _PHASE24_CPU % {"repo": repo}], cwd=repo,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    r = json.loads(lines[-1][len("RESULT "):])
    assert r["foreign"] == []
    a, b = r["a"], r["b"]
    assert a["capacity"]["ratio"] >= 5
    assert a["spill"]["on"]["evicted"] == a["spill"]["off"]["spilled"] == 0
    assert a["launches"] == a["loadkv"]["received"] == a["plain_copies"] \
        == 16
    assert b["sockets_left"] == 0 and b["golden"]["resp_bytes"] == 19
