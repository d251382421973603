"""Card-only tests of the port: the p2p_copy and ring kernels, and the
device plane and the sharded layout on a CUDA mesh.  A CUDA kernel has no
CPU mode, so every test here carries the ``cuda`` marker and skips without
a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  On the card, without the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici import pallas_ring
from brpc_tpu_torch.ici.collective import Collectives
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.ici.p2p_copy import P2PCopy, p2p_copy, p2p_copy_plain


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _seeded(nbytes: int) -> np.ndarray:
    return np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)


@pytest.mark.cuda
def test_kernel_launch_matches_plain_version(cuda_device):
    kern = P2PCopy()
    for offset, n in ((0, 4096), (3, 65537), (0, 4 << 20)):
        data = torch.from_numpy(_seeded(offset + n)).to(cuda_device)
        src = data[offset:]
        out = kern(src, torch.empty(n, dtype=torch.uint8, device=cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(out, p2p_copy_plain(src, torch.empty_like(out)))
    assert kern.launches == 3


@pytest.mark.cuda
def test_plane_moves_exact_bytes_between_ranks_of_one_card(cuda_device):
    """One rendezvous on a CUDA mesh: one kernel launch, the output owned
    by the dst rank, the source pin released once at completion."""
    mesh = IciMesh(ranks=8, device="cuda")
    plane = dp.plane()
    data = _seeded(65537)
    src = mesh.device_put(torch.from_numpy(data).to(cuda_device), 1)
    released = []
    launches0, transfers0 = p2p_copy.launches, plane.stats()["transfers"]
    t = plane.post_send(src, 1, 0, mesh=mesh)
    t.add_source_release(lambda: released.append(1))
    plane.post_recv(t.uuid)
    assert t.wait(30) == 0
    assert t.state == dp.COMPLETE
    assert released == [1]
    assert mesh.rank_of(t.out) == 0
    np.testing.assert_array_equal(t.out.cpu().numpy(), data)
    assert p2p_copy.launches - launches0 == 1
    assert plane.stats()["transfers"] - transfers0 == 1
    assert plane.active_transfers() == 0


def _ring_rows(dev, n, chunk, dtype, offset=0):
    """n seeded rows of mixed magnitude; ``offset`` elements into a larger
    buffer, so offset 1 gives rows that are not 16-byte aligned."""
    rng = np.random.default_rng(n * 1000 + chunk)
    x = (rng.standard_normal((n, chunk))
         * 10.0 ** rng.integers(-4, 5, (n, chunk)))
    rows = []
    for r in range(n):
        buf = torch.empty(chunk + offset, dtype=dtype, device=dev)
        buf[offset:] = torch.from_numpy(x[r].astype(np.float32)).to(dev)
        rows.append(buf[offset:])
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("n,chunk,dtype,offset", [
    (8, 4096, torch.float32, 0),
    (8, 1003, torch.float32, 0),         # ragged tail
    (8, 4096, torch.bfloat16, 0),
    (8, 1000, torch.float16, 0),
    (8, 4096, torch.float32, 1),         # rows not 16-byte aligned
    (2, 513, torch.float32, 0),
    (3, 4096, torch.bfloat16, 0),
    (20, 4096, torch.float32, 0),        # past the register path
], ids=["f32", "ragged", "bf16", "f16", "misaligned", "n2", "n3", "n20"])
def test_ring_kernels_match_their_plain_versions(cuda_device, n, chunk, dtype,
                                                 offset):
    rows = _ring_rows(cuda_device, n, chunk, dtype, offset)
    red, gat = pallas_ring.RingAllReduce(), pallas_ring.RingAllGather()
    out = red(rows, [torch.empty(chunk, dtype=dtype, device=cuda_device)
                     for _ in range(n)])
    ref = pallas_ring.ring_all_reduce_plain(
        rows, [torch.empty(chunk, dtype=dtype, device=cuda_device)
               for _ in range(n)])
    gout = gat(rows, [torch.empty(n, chunk, dtype=dtype, device=cuda_device)
                      for _ in range(n)])
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for g in gout:
        assert torch.equal(g, torch.stack(rows))
    assert red.launches == gat.launches == 1


@pytest.mark.cuda
def test_ring_kernel_int32_wraps_like_the_plain_version(cuda_device):
    rows = [torch.full((100,), 2**31 - 1 - r, dtype=torch.int32,
                       device=cuda_device) for r in range(8)]
    out = pallas_ring.ring_all_reduce_kernel(
        rows, [torch.empty_like(t) for t in rows])
    ref = pallas_ring.ring_all_reduce_plain(
        rows, [torch.empty_like(t) for t in rows])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
def test_sharded_rows_are_owned_by_their_ranks_on_the_card(cuda_device):
    mesh = IciMesh(ranks=8, device="cuda")
    coll = Collectives(mesh)
    xs = coll.shard(torch.arange(8 * 5, dtype=torch.float32).reshape(8, 5))
    assert xs.device.type == "cuda"
    assert [mesh.rank_of(xs.row(r)) for r in range(8)] == list(range(8))
    launches = pallas_ring.ring_all_reduce_kernel.launches
    out = pallas_ring.ring_all_reduce(xs)
    assert pallas_ring.ring_all_reduce_kernel.launches == launches + 1
    assert [mesh.rank_of(t) for t in out] == list(range(8))
    assert torch.equal(out.row(3), coll.all_reduce(xs))  # integers: exact
