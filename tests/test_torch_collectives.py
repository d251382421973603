"""The port's collective substrate against the JAX package: mesh topology,
``Collectives``, ``ring.ring_all_reduce``, ``RingStream``, the
``CollectiveChannel`` lowering and the sharded layout.

The same seeded numpy inputs go through the JAX functions (8-device CPU
mesh) and the port (``IciMesh(ranks=8, device="cpu")``).  Tolerances:
  * gathers, ppermute, broadcast, all_to_all and the channel's gathers:
    exact (data moves);
  * ``ring.ring_all_reduce``: exact — the same ring order as the JAX scan;
  * psum and reduce_scatter: the port folds in rank order, XLA in its own,
    so float32 agrees within ``atol = 1e-6 · n · max Σ|x|``;
  * CollectiveChannel sums: rtol 1e-5, as the JAX test holds them.
"""
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu import channels as jchannels
from brpc_tpu import ici as jici
from brpc_tpu.ici import ring as jring
from brpc_tpu_torch import channels
from brpc_tpu_torch.convert import sharded_from_numpy
from brpc_tpu_torch.ici import pallas_ring
from brpc_tpu_torch.ici import ring as ring_mod
from brpc_tpu_torch.ici.collective import Collectives
from brpc_tpu_torch.ici.mesh import IciMesh, ShardedTensor

N = 8


@pytest.fixture(scope="module")
def jcoll():
    import jax
    return jici.Collectives(jici.IciMesh(jax.devices()))


@pytest.fixture(scope="module")
def mesh():
    return IciMesh(ranks=N, device="cpu")


@pytest.fixture(scope="module")
def coll(mesh):
    return Collectives(mesh)


def _mixed(shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 5, shape)
    return x.astype(np.float32)


def _sum_atol(x: np.ndarray) -> float:
    """1e-6 · n · max Σ|x| over the summed axis 0."""
    return 1e-6 * len(x) * float(np.abs(x).sum(0).max())


# ---- mesh ----------------------------------------------------------------
def test_mesh_topology_matches_jax(jcoll, mesh):
    jm = jcoll.mesh
    assert [(e.scheme, e.coords) for e in mesh.endpoints()] == \
        [(e.scheme, e.coords) for e in jm.endpoints()]
    for shift in (1, 3, -1, 8):
        assert mesh.ring_perm(shift) == jm.ring_perm(shift)
    for r in range(N):
        assert mesh.neighbors(r) == jm.neighbors(r)
    assert IciMesh(ranks=1, device="cpu").neighbors(0) == [0]


def test_shard_puts_row_r_on_rank_r(coll, mesh):
    x = torch.arange(N * 3, dtype=torch.float32).reshape(N, 3)
    xs = coll.shard(x)
    assert tuple(xs.shape) == (N, 3) and xs.dtype == torch.float32
    assert xs.device == torch.device("cpu")
    assert [mesh.rank_of(xs.row(r)) for r in range(N)] == list(range(N))
    assert torch.equal(xs.stack(), x)
    assert [t.tolist() for t in xs] == x.tolist()      # iterates rows
    rep = coll.replicate(x[0])
    assert mesh.rank_of(rep) == -1 and rep.device == mesh.device(0)
    with pytest.raises(ValueError):
        coll.shard(torch.zeros(N + 1, 2))


def test_sharded_tensor_refuses_rows_not_owned_by_their_rank(mesh):
    rows = [mesh.device_put(torch.zeros(2), r) for r in range(N)]
    ShardedTensor(rows, mesh)
    with pytest.raises(ValueError, match="owned by rank"):
        ShardedTensor(rows[1:] + rows[:1], mesh)
    with pytest.raises(ValueError):
        ShardedTensor(rows[:-1], mesh)
    odd = rows[:-1] + [mesh.device_put(torch.zeros(3), N - 1)]
    with pytest.raises(ValueError):
        ShardedTensor(odd, mesh)


def test_sharded_from_numpy_keeps_bfloat16_bits(jcoll, mesh):
    import jax.numpy as jnp
    xj = jcoll.shard(jnp.asarray(_mixed((N, 33)), jnp.bfloat16))
    xs = sharded_from_numpy(np.asarray(xj), mesh)
    assert xs.dtype == torch.bfloat16
    assert [mesh.rank_of(t) for t in xs] == list(range(N))
    np.testing.assert_array_equal(
        xs.stack().view(torch.int16).numpy().view(np.uint16),
        np.asarray(xj).view(np.uint16))


# ---- collectives ---------------------------------------------------------
def test_psum_matches_jax_within_sum_order(jcoll, coll):
    x = _mixed((N, 300), seed=1)
    expect = np.asarray(jcoll.all_reduce(jcoll.shard(x)))
    got = coll.all_reduce(coll.shard(torch.from_numpy(x)))
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), expect, rtol=0,
                               atol=_sum_atol(x))


def test_reduce_scatter_matches_jax_within_sum_order(jcoll, coll, mesh):
    x = _mixed((N, N, 5), seed=2)
    expect = np.asarray(jcoll.reduce_scatter(jcoll.shard(x)))
    got = coll.reduce_scatter(coll.shard(torch.from_numpy(x)))
    assert tuple(got.shape) == expect.shape == (N, 1, 5)
    assert [mesh.rank_of(t) for t in got] == list(range(N))
    np.testing.assert_allclose(got.stack().numpy(), expect, rtol=0,
                               atol=_sum_atol(x))


def test_all_gather_is_exact(jcoll, coll):
    x = _mixed((N, 7), seed=3)
    expect = np.asarray(jcoll.all_gather(jcoll.shard(x)))
    np.testing.assert_array_equal(
        coll.all_gather(coll.shard(torch.from_numpy(x))).numpy(), expect)


@pytest.mark.parametrize("shift", [1, 3, -1, 8])
def test_ppermute_is_exact(jcoll, coll, mesh, shift):
    x = _mixed((N, 6), seed=4)
    expect = np.asarray(jcoll.ppermute(jcoll.shard(x), shift))
    got = coll.ppermute(coll.shard(torch.from_numpy(x)), shift)
    assert [mesh.rank_of(t) for t in got] == list(range(N))
    np.testing.assert_array_equal(got.stack().numpy(), expect)


@pytest.mark.parametrize("root", [0, 5])
def test_broadcast_is_exact(jcoll, coll, root):
    x = _mixed((N, 6), seed=5)
    expect = np.asarray(jcoll.broadcast(jcoll.shard(x), root))
    np.testing.assert_array_equal(
        coll.broadcast(coll.shard(torch.from_numpy(x)), root).numpy(), expect)


def test_all_to_all_is_exact(jcoll, coll, mesh):
    x = _mixed((N, N, 3), seed=6)
    expect = np.asarray(jcoll.all_to_all(jcoll.shard(x)))
    got = coll.all_to_all(coll.shard(torch.from_numpy(x)))
    assert [mesh.rank_of(t) for t in got] == list(range(N))
    np.testing.assert_array_equal(got.stack().numpy(), expect)


def test_collectives_refuse_plain_tensors_and_other_meshes(coll):
    with pytest.raises(TypeError):
        coll.all_reduce(torch.zeros(N, 2))
    other = Collectives(IciMesh(ranks=N, device="cpu"))
    with pytest.raises(ValueError):
        coll.ppermute(other.shard(torch.zeros(N, 2)))
    with pytest.raises(ValueError):
        coll.all_to_all(coll.shard(torch.zeros(N, 3)))


# ---- ring ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_all_reduce_matches_jax_ring_bit_for_bit(jcoll, mesh, dtype):
    """Same hop order as the JAX ``lax.scan`` of ppermute, and so the same
    bits as the ring kernel's plain version."""
    import jax.numpy as jnp
    xj = jcoll.shard(jnp.asarray(_mixed((N, 200), seed=7), dtype))
    expect = np.asarray(jring.ring_all_reduce(xj, jcoll.mesh))
    xs = sharded_from_numpy(np.asarray(xj), mesh)
    got = ring_mod.ring_all_reduce(xs)
    assert [mesh.rank_of(t) for t in got] == list(range(N))
    view = (lambda t: t.view(torch.int16).numpy().view(np.uint16)) \
        if dtype == "bfloat16" else (lambda t: t.numpy().view(np.uint32))
    np.testing.assert_array_equal(view(got.stack()),
                                  expect.view(view(got.stack()).dtype))
    assert torch.equal(got.stack(), pallas_ring.ring_all_reduce(xs).stack())


def test_ring_stream_window_and_order_match_jax(jcoll, mesh):
    import jax.numpy as jnp
    chunks = [_mixed((N, 4), seed=10 + i) for i in range(6)]
    got_j, got = [], []
    js = jici.RingStream(hops=2, window=2, mesh=jcoll.mesh,
                         on_chunk=lambda c: got_j.append(np.asarray(c)))
    ps = ring_mod.RingStream(hops=2, window=2, mesh=mesh,
                             on_chunk=lambda c: got.append(c.stack().numpy()))
    coll = Collectives(mesh)
    for c in chunks:
        assert js.write(jcoll.shard(jnp.asarray(c)))
        assert ps.write(coll.shard(torch.from_numpy(c)))
    assert js.flush(60) and ps.flush(60)
    assert len(got) == len(got_j) == 6 and ps.in_flight == 0
    for c, a, b in zip(chunks, got, got_j):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.roll(c, 2, axis=0))


def _bare_stream(coll, window):
    stream = ring_mod.RingStream.__new__(ring_mod.RingStream)
    stream.mesh = None
    stream.coll = coll
    stream.hops = 1
    stream.window = window
    stream.on_chunk = None
    stream._cv = threading.Condition()
    stream._produced = 0
    stream._consumed = 0
    return stream


def test_ring_stream_two_writers_never_overshoot_window(monkeypatch):
    """Check-and-reserve under one lock: with window=1 at most one chunk
    is ever mid-dispatch, however two writers race."""
    lock = threading.Lock()
    state = {"active": 0, "peak": 0}
    pending = []

    class FakeColl:
        def ppermute(self, x, shift):
            with lock:
                state["active"] += 1
                state["peak"] = max(state["peak"], state["active"])
            time.sleep(0.03)         # widen the race window
            with lock:
                state["active"] -= 1
            return x

    class FakeDisp:
        def on_ready(self, tensors, cb):
            t = threading.Timer(0.01, cb)   # consume later, like the poller
            t.daemon = True
            t.start()
            pending.append(t)

    monkeypatch.setattr(ring_mod.DeviceEventDispatcher, "instance",
                        classmethod(lambda cls: FakeDisp()))
    stream = _bare_stream(FakeColl(), window=1)
    errs = []

    def writer():
        try:
            for _ in range(5):
                assert stream.write(object(), timeout=10)
        except Exception as e:       # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errs, errs
    assert stream.flush(10)
    assert state["peak"] == 1, f"window overshoot: {state['peak']}"
    assert stream.in_flight == 0
    for t in pending:
        t.join(5)


def test_ring_stream_failed_dispatch_returns_reserved_credit(monkeypatch):
    class BoomColl:
        calls = 0

        def ppermute(self, x, shift):
            BoomColl.calls += 1
            if BoomColl.calls == 1:
                raise RuntimeError("transfer failed")
            return x

    class FakeDisp:
        def on_ready(self, tensors, cb):
            cb()

    monkeypatch.setattr(ring_mod.DeviceEventDispatcher, "instance",
                        classmethod(lambda cls: FakeDisp()))
    stream = _bare_stream(BoomColl(), window=1)
    with pytest.raises(RuntimeError):
        stream.write(object(), timeout=1)
    assert stream.in_flight == 0                 # credit rolled back
    assert stream.write(object(), timeout=1)     # window not wedged
    assert stream.flush(5)


def test_ring_stream_write_times_out_on_a_full_window(mesh):
    stream = ring_mod.RingStream(window=1, mesh=mesh)
    stream._produced = 1                         # one chunk never consumed
    t0 = time.monotonic()
    assert not stream.write(Collectives(mesh).shard(torch.zeros(N, 1)),
                            timeout=0.05)
    assert time.monotonic() - t0 < 5 and stream.in_flight == 1


# ---- CollectiveChannel: the four JAX cases (tests/test_channels.py) ------
@pytest.fixture(scope="module")
def channel_pair(jcoll, mesh):
    return jchannels.CollectiveChannel(jcoll.mesh), \
        channels.CollectiveChannel(mesh)


def test_channel_shard_and_sum_is_distributed_matvec(channel_pair):
    jch, ch = channel_pair
    d = 8
    w = np.arange(N * d * d, dtype=np.float32).reshape(N, d, d) / 100
    x = np.ones((d,), np.float32)
    for c in (jch, ch):
        c.register("Shard.PartialMatVec",
                   lambda w_shard, x_full: w_shard @ x_full,
                   merge=channels.MERGE_SUM, mapping=channels.MAP_SHARD)
    expect = np.asarray(jch.call("Shard.PartialMatVec", jch.shard(w),
                                 jch.replicate(x)))
    got = ch.call("Shard.PartialMatVec", ch.shard(torch.from_numpy(w)),
                  ch.replicate(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), w.sum(0) @ x, rtol=1e-5)


def test_channel_gather_merge_collects_all_responses(channel_pair):
    jch, ch = channel_pair
    for c in (jch, ch):
        c.register("Shard.Scale", lambda idx, row: row * (idx + 1),
                   merge=channels.MERGE_GATHER, mapping=channels.MAP_SHARD,
                   takes_index=True)
    x = _mixed((N, 4), seed=8)
    expect = np.asarray(jch.call("Shard.Scale", jch.shard(x)))
    got = ch.call("Shard.Scale", ch.shard(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5)


def test_channel_none_merge_keeps_sharded(channel_pair, mesh):
    jch, ch = channel_pair
    for c in (jch, ch):
        c.register("Shard.Double", lambda row: row * 2,
                   merge=channels.MERGE_NONE, mapping=channels.MAP_SHARD)
    x = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    expect = np.asarray(jch.call("Shard.Double", jch.shard(x)))
    got = ch.call("Shard.Double", ch.shard(torch.from_numpy(x)))
    assert isinstance(got, ShardedTensor)                 # stayed sharded
    assert [mesh.rank_of(t) for t in got] == list(range(N))
    np.testing.assert_allclose(got.stack().numpy(), expect, rtol=1e-5)


def test_channel_identity_twice_with_new_inputs(channel_pair, mesh):
    """The JAX case checks its program cache; the port compiles nothing, so
    it checks that two calls of one method follow their inputs."""
    jch, ch = channel_pair
    for c in (jch, ch):
        c.register("Shard.Id", lambda row: row, merge=channels.MERGE_NONE)
    x = np.ones((N, 3), np.float32)
    for scale in (1, 5):
        expect = np.asarray(jch.call("Shard.Id", jch.shard(x * scale)))
        got = ch.call("Shard.Id", ch.shard(torch.from_numpy(x * scale)))
        np.testing.assert_allclose(got.stack().numpy(), expect, rtol=1e-5)
    assert not hasattr(ch, "_compiled")


def test_channel_concat_merge_and_replicated_results(channel_pair, mesh):
    """MERGE_CONCAT stacks along axis 0; a handler that returns its
    replicated operand gets a copy per rank, and the operand stays owned
    by no rank."""
    jch, ch = channel_pair
    x = _mixed((N, 2, 3), seed=9)
    for c in (jch, ch):
        c.register("Shard.Cat", lambda row: row + 1,
                   merge=channels.MERGE_CONCAT)
    expect = np.asarray(jch.call("Shard.Cat", jch.shard(x)))
    got = ch.call("Shard.Cat", ch.shard(torch.from_numpy(x)))
    assert got.shape == expect.shape == (N * 2, 3)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5)
    ch.register("Echo", lambda v: v, merge=channels.MERGE_NONE)
    v = ch.replicate(torch.arange(4.0))
    out = ch.call("Echo", v)
    assert mesh.rank_of(v) == -1
    assert [mesh.rank_of(t) for t in out] == list(range(N))
    assert all(torch.equal(t, v) for t in out)
