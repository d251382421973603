"""Card-only tests of the port: the p2p_copy kernel and the device plane on
a CUDA mesh.  A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  On the card, without the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from brpc_tpu_torch.ici import device_plane as dp
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
