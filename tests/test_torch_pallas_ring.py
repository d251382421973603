"""The ring kernels of the port (brpc_tpu_torch/ici/pallas_ring.py) against
the JAX package's Pallas ring kernels.

The same seeded numpy rows go through ``brpc_tpu.ici.pallas_ring`` (on the
8-device CPU mesh, Pallas in interpret mode, as tests/test_pallas_ring.py
runs it) and through the port on ``IciMesh(ranks=8, device="cpu")``, where
each wrapper runs its plain version.  Tolerance: exact, bit for bit, in
float32, bfloat16 and int32 — the port folds in the ring's order and
rounds after every hop, so even the per-rank differences in the last bits
agree.  The kernel launches themselves need a card:
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from brpc_tpu import ici as jici
from brpc_tpu.ici import pallas_ring as jpr
from brpc_tpu.ici.collective import Collectives as JaxCollectives
from brpc_tpu_torch.convert import sharded_from_numpy
from brpc_tpu_torch.ici import pallas_ring as ppr
from brpc_tpu_torch.ici.cuda_kernel import NVCC_FLAGS
from brpc_tpu_torch.ici.mesh import IciMesh, ShardedTensor
from brpc_tpu_torch.ici.p2p_copy import NVCC_FLAGS as P2P_NVCC_FLAGS


@pytest.fixture(scope="module")
def jax_coll():
    import jax
    return JaxCollectives(jici.IciMesh(jax.devices()))


@pytest.fixture(scope="module")
def mesh():
    return IciMesh(ranks=8, device="cpu")


def _rows(kind: str, chunk: int, seed: int = 0, n: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, (n, chunk), dtype=np.int64
                            ).astype(np.int32)
    x = rng.standard_normal((n, chunk))
    if kind == "mixed":          # magnitudes 1e-6..1e6: per-rank orders differ
        x = x * 10.0 ** rng.integers(-6, 7, (n, chunk))
    return x.astype(np.float32)


_JAX_DTYPE = {"float32": "float32", "mixed": "float32", "bfloat16": "bfloat16",
              "int32": "int32"}


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy array or a CPU tensor, for exact compares."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
             else a.numpy())
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _both(jax_coll, kind, chunk, seed=0):
    """(JAX sharded array, its numpy export) for one seeded input."""
    import jax.numpy as jnp
    xj = jax_coll.shard(jnp.asarray(_rows(kind, chunk, seed),
                                    _JAX_DTYPE[kind]))
    return xj, np.asarray(xj)


@pytest.mark.parametrize("kind", ["float32", "mixed", "bfloat16", "int32"])
def test_all_reduce_matches_pallas_kernel_bit_for_bit(jax_coll, mesh, kind):
    xj, rows = _both(jax_coll, kind, 256)
    expect = np.asarray(jpr.ring_all_reduce(xj, jax_coll.mesh))
    got = ppr.ring_all_reduce(sharded_from_numpy(rows, mesh))
    assert isinstance(got, ShardedTensor) and tuple(got.shape) == (8, 256)
    np.testing.assert_array_equal(_bits(got.stack()), _bits(expect))


def test_all_reduce_rows_differ_per_rank_where_jax_does(jax_coll, mesh):
    """On mixed-magnitude rows each rank's fold order gives other last
    bits; the port's rows differ from rank 0's at exactly JAX's places."""
    xj, rows = _both(jax_coll, "mixed", 512, seed=3)
    expect = _bits(np.asarray(jpr.ring_all_reduce(xj, jax_coll.mesh)))
    got = _bits(ppr.ring_all_reduce(sharded_from_numpy(rows, mesh)).stack())
    jax_differs = expect != expect[0]
    assert jax_differs.any()
    np.testing.assert_array_equal(got != got[0], jax_differs)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int32"])
def test_all_gather_matches_pallas_kernel_bit_for_bit(jax_coll, mesh, kind):
    xj, rows = _both(jax_coll, kind, 128, seed=1)
    expect = np.asarray(jpr.ring_all_gather(xj, jax_coll.mesh))
    got = ppr.ring_all_gather(sharded_from_numpy(rows, mesh))
    assert tuple(got.shape) == (8, 8, 128)
    np.testing.assert_array_equal(_bits(got.stack()), _bits(expect))


def test_ragged_chunk_matches_pallas_kernels(jax_coll, mesh):
    """1,003 elements: not a whole number of 16-byte vectors."""
    xj, rows = _both(jax_coll, "mixed", 1003, seed=2)
    xs = sharded_from_numpy(rows, mesh)
    np.testing.assert_array_equal(
        _bits(ppr.ring_all_reduce(xs).stack()),
        _bits(np.asarray(jpr.ring_all_reduce(xj, jax_coll.mesh))))
    np.testing.assert_array_equal(
        _bits(ppr.ring_all_gather(xs).stack()),
        _bits(np.asarray(jpr.ring_all_gather(xj, jax_coll.mesh))))


def _numpy_fold(x: np.ndarray) -> np.ndarray:
    """Rank d: x[d+1] + x[d+2] + ... + x[d] (mod n), float32 after each add."""
    n = len(x)
    out = np.empty_like(x)
    for d in range(n):
        acc = x[(d + 1) % n].copy()
        for j in range(2, n + 1):
            acc = (acc + x[(d + j) % n]).astype(x.dtype)
        out[d] = acc
    return out


@pytest.mark.parametrize("n", [2, 3, 5, 20])
def test_any_mesh_size_folds_in_ring_order(n):
    """Mesh sizes the JAX CPU mesh cannot hold, against a numpy fold."""
    mesh = IciMesh(ranks=n, device="cpu")
    rows = _rows("mixed", 67, seed=n, n=n)
    xs = sharded_from_numpy(rows, mesh)
    np.testing.assert_array_equal(_bits(ppr.ring_all_reduce(xs).stack()),
                                  _bits(_numpy_fold(rows)))
    gathered = ppr.ring_all_gather(xs).stack().numpy()
    np.testing.assert_array_equal(gathered, np.broadcast_to(rows, (n,) +
                                                            rows.shape))


def test_results_are_owned_by_their_ranks(mesh):
    xs = sharded_from_numpy(_rows("float32", 16), mesh)
    for out in (ppr.ring_all_reduce(xs), ppr.ring_all_gather(xs)):
        assert [mesh.rank_of(t) for t in out] == list(range(8))


def test_mesh_of_one_returns_without_a_kernel():
    one = IciMesh(ranks=1, device="cpu")
    xs = sharded_from_numpy(_rows("float32", 8, n=1), one)
    before = (ppr.ring_all_reduce_kernel.launches,
              ppr.ring_all_gather_kernel.launches)
    assert ppr.ring_all_reduce(xs) is xs
    g = ppr.ring_all_gather(xs)
    assert tuple(g.shape) == (1, 1, 8)
    assert torch.equal(g.row(0)[0], xs.row(0))
    assert (ppr.ring_all_reduce_kernel.launches,
            ppr.ring_all_gather_kernel.launches) == before


def test_cpu_rows_take_the_plain_versions_without_a_launch():
    rows = [torch.full((5,), float(r)) for r in range(3)]
    red, gat = ppr.RingAllReduce(), ppr.RingAllGather()
    out = red(rows, [torch.empty(5) for _ in range(3)])
    assert all(torch.equal(t, torch.full((5,), 3.0)) for t in out)
    out = gat(rows, [torch.empty(3, 5) for _ in range(3)])
    assert all(torch.equal(t, torch.stack(rows)) for t in out)
    assert red.launches == gat.launches == 0
    assert not red.built and not gat.built    # nothing compiled or loaded


def _f(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("make", [
    lambda: ([_f(4, dtype=torch.float64)] * 2, [_f(4, dtype=torch.float64)] * 2),
    lambda: ([_f(4), _f(5)], [_f(4), _f(4)]),
    lambda: ([_f(8)[::2], _f(4)], [_f(4), _f(4)]),
    lambda: ([_f(4), _f(4)], [_f(4), _f(5)]),
    lambda: ([_f(4), _f(4)], [_f(4)]),
    lambda: ([_f(4), _f(4, device="meta")], [_f(4), _f(4)]),
    lambda: ([_f(4, device="meta")] * 2, [_f(4, device="meta")] * 2),
    lambda: (_f(2, 4), [_f(4), _f(4)]),
    lambda: ([_f(4), b"1234"], [_f(4), _f(4)]),
    lambda: ([_f(1)] * 129, [_f(1)] * 129),
    lambda: ([], []),
], ids=["dtype", "row-shape", "strided", "out-shape", "count", "mixed-device",
        "device", "not-a-list", "not-a-tensor", "too-many-ranks", "no-rows"])
def test_all_reduce_wrapper_rejects_what_the_kernel_does_not_take(make):
    rows, outs = make()
    with pytest.raises((TypeError, ValueError)):
        ppr.ring_all_reduce_kernel(rows, outs)


@pytest.mark.parametrize("make", [
    lambda: ([_f(4), _f(4)], [_f(4), _f(4)]),
    lambda: ([_f(4), _f(4, dtype=torch.int32)], [_f(2, 4), _f(2, 4)]),
    lambda: ([_f(4), _f(4)], [_f(2, 8)[:, ::2], _f(2, 4)]),
    lambda: ([_f(4), _f(4)], [_f(2, 4), _f(2, 4, device="meta")]),
], ids=["out-shape", "mixed-dtype", "strided-out", "mixed-device"])
def test_all_gather_wrapper_rejects_what_the_kernel_does_not_take(make):
    rows, outs = make()
    with pytest.raises((TypeError, ValueError)):
        ppr.ring_all_gather_kernel(rows, outs)


def test_entry_points_take_sharded_values_of_their_mesh(mesh):
    with pytest.raises(TypeError):
        ppr.ring_all_reduce(torch.zeros(8, 4), mesh)
    xs = sharded_from_numpy(_rows("float32", 4), mesh)
    with pytest.raises(ValueError):
        ppr.ring_all_gather(xs, IciMesh(ranks=8, device="cpu"))


def test_build_targets_hopper_from_the_package_sources():
    assert P2P_NVCC_FLAGS is NVCC_FLAGS        # one build recipe for all
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    for kern, tpu, bound in (
            (ppr.ring_all_reduce_kernel, "_build_all_reduce.kernel", "40.1 us"),
            (ppr.ring_all_gather_kernel, "_build_all_gather.kernel",
             "180.3 us")):
        assert kern.source.exists() and kern.source.suffix == ".cu"
        text = kern.source.read_text()
        # the source names the TPU kernel it replaces and its bound
        assert tpu in text and "3.35 TB/s" in text and bound in text
        assert f'extern "C" int {kern.launcher}' in text
        assert "#include <torch" not in text      # a plain C interface
        assert kern.library_path().parent.name == "_build"
