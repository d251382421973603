"""Ring attention and Ulysses sequence parallelism of the port against the
JAX package (brpc_tpu/ici/ring_attention.py).

The same seeded numpy q, k, v go through the JAX functions on the 8-device
CPU mesh and through the port on ``IciMesh(ranks=8, device="cpu")``.
Tolerance: rtol = atol = 1e-5 against the JAX outputs (both compute in
float32; matmul sum order and ``exp`` differ in the last bits), and the JAX
test's 2e-4 / 2e-5 against the dense reference.
"""
import numpy as np
import pytest
import torch

from brpc_tpu import ici as jici
from brpc_tpu.ici import ring_attention as jra
from brpc_tpu_torch.convert import sharded_from_numpy
from brpc_tpu_torch.ici import ring_attention as ra
from brpc_tpu_torch.ici.mesh import IciMesh

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jcoll():
    import jax
    return jici.Collectives(jici.IciMesh(jax.devices()))


@pytest.fixture(scope="module")
def mesh():
    return IciMesh(ranks=8, device="cpu")


def make_qkv(jcoll, mesh, block=16, heads=8, dim=32, seed=0):
    """(q, k, v) as numpy (S, H, D), JAX sharded and port sharded."""
    n = mesh.size
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((n * block, heads, dim)).astype(np.float32)
           for _ in range(3)]
    rows = [x.reshape(n, block, heads, dim) for x in qkv]
    return (qkv, [jcoll.shard(r) for r in rows],
            [sharded_from_numpy(r, mesh) for r in rows])


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(jcoll, mesh, causal):
    _, js, ps = make_qkv(jcoll, mesh, seed=int(causal))
    expect = np.asarray(jra.ring_attention(*js, jcoll.mesh, causal=causal))
    got = ra.ring_attention(*ps, causal=causal)
    assert tuple(got.shape) == expect.shape
    np.testing.assert_allclose(got.stack().numpy(), expect, **TOL)


def test_ulysses_attention_matches_jax(jcoll, mesh):
    _, js, ps = make_qkv(jcoll, mesh, seed=2)
    expect = np.asarray(jra.ulysses_attention(*js, jcoll.mesh))
    got = ra.ulysses_attention(*ps)
    np.testing.assert_allclose(got.stack().numpy(), expect, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(jcoll, mesh, causal):
    (q, k, v), _, _ = make_qkv(jcoll, mesh, seed=3)
    expect = np.asarray(jra.reference_attention(q, k, v, causal=causal))
    got = ra.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_and_ulysses_match_dense_reference(jcoll, mesh, causal):
    (q, k, v), _, ps = make_qkv(jcoll, mesh, seed=4)
    dense = ra.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal).numpy()
    ring = ra.ring_attention(*ps, causal=causal).stack().numpy()
    np.testing.assert_allclose(ring.reshape(q.shape), dense, rtol=2e-4,
                               atol=2e-5)
    if not causal:
        uly = ra.ulysses_attention(*ps).stack().numpy()
        np.testing.assert_allclose(uly.reshape(q.shape), dense, rtol=2e-4,
                                   atol=2e-5)


def test_layout_stays_sharded_and_dtype_returns(jcoll, mesh):
    _, _, (q, k, v) = make_qkv(jcoll, mesh, block=4, heads=8, dim=8, seed=5)
    for out in (ra.ring_attention(q, k, v), ra.ulysses_attention(q, k, v)):
        assert out.shape == q.shape and out.dtype == q.dtype
        assert [mesh.rank_of(t) for t in out] == list(range(mesh.size))
    half = [x.map(lambda t: t.to(torch.bfloat16)) for x in (q, k, v)]
    assert ra.ring_attention(*half).dtype == torch.bfloat16


def test_ulysses_needs_heads_divisible_by_ranks(jcoll, mesh):
    _, _, ps = make_qkv(jcoll, mesh, block=4, heads=4, dim=8)
    with pytest.raises(ValueError, match="heads"):
        ra.ulysses_attention(*ps)
