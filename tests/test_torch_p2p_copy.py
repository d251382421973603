"""p2p_copy (brpc_tpu_torch/ici/p2p_copy.py): the port of the device
plane's Pallas remote-copy kernel.

On the CPU the wrapper runs its plain version; it is held bit-exact
against the JAX package's ``DevicePlane._pallas_body`` kernel in interpret
mode on the same seeded payloads (tolerance: exact, the data is uint8).
The kernel launch itself needs a card: tests/test_torch_cuda.py.
"""
import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from brpc_tpu.butil import flags as jfl
from brpc_tpu.ici import device_plane as jdp
from brpc_tpu.ici.mesh import IciMesh as JaxMesh
from brpc_tpu_torch.ici import cuda_kernel
from brpc_tpu_torch.ici.cuda_kernel import DeviceRecord
from brpc_tpu_torch.ici.p2p_copy import (P2PCopy, p2p_copy, p2p_copy_plain,
                                         NVCC_FLAGS, SOURCE)


@pytest.fixture()
def jax_pallas_plane():
    """The JAX plane with its Pallas kernel, engaged on the CPU mesh."""
    names = ("ici_device_plane", "ici_device_plane_host_mesh",
             "ici_device_plane_threshold", "ici_device_plane_kernel")
    saved = {n: jfl.get_flag(n) for n in names}
    jfl.set_flag("ici_device_plane", True)
    jfl.set_flag("ici_device_plane_host_mesh", True)
    jfl.set_flag("ici_device_plane_threshold", 1024)
    jfl.set_flag("ici_device_plane_kernel", "pallas")
    yield jdp.plane()
    for n, v in saved.items():
        jfl.set_flag(n, v)


def _seeded(nbytes: int) -> np.ndarray:
    return np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)


@pytest.mark.parametrize("nbytes", [2048, 65537, 1 << 20])
def test_plain_version_matches_pallas_kernel(jax_pallas_plane, nbytes):
    import jax
    plane = jax_pallas_plane
    data = _seeded(nbytes)
    f0 = plane.stats()["fallbacks"]
    arr = jax.device_put(data, JaxMesh.default().device(2))
    t = plane.post_send(arr, 2, 6)
    plane.post_recv(t.uuid)
    assert t.wait(60) == 0
    # the compiled Pallas program moved the bytes, not the device_put
    # degrade path
    assert plane.stats()["fallbacks"] == f0
    jax_out = np.asarray(t.out)

    src = torch.from_numpy(data.copy())
    plain = p2p_copy_plain(src, torch.empty(nbytes, dtype=torch.uint8))
    wrapped = p2p_copy(src, torch.empty(nbytes, dtype=torch.uint8))
    np.testing.assert_array_equal(plain.numpy(), jax_out)
    np.testing.assert_array_equal(wrapped.numpy(), jax_out)


@pytest.mark.parametrize("offset,length", [(1, 65537), (7, 4093), (0, 1)])
def test_plain_version_copies_misaligned_slices(offset, length):
    data = torch.from_numpy(_seeded(offset + length + 5))
    src = data[offset:offset + length]
    out = p2p_copy(src, torch.empty(length, dtype=torch.uint8))
    assert torch.equal(out, src)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    kern = P2PCopy()
    src = torch.arange(64, dtype=torch.uint8)
    out = kern(src, torch.zeros(64, dtype=torch.uint8))
    assert torch.equal(out, src)
    assert kern.launches == 0
    assert not kern.built          # nothing was compiled or loaded


@pytest.mark.parametrize("bad", [
    lambda: (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.uint8)),
    lambda: (torch.zeros(2, 4, dtype=torch.uint8), torch.zeros(8, dtype=torch.uint8)),
    lambda: (torch.zeros(16, dtype=torch.uint8)[::2], torch.zeros(8, dtype=torch.uint8)),
    lambda: (torch.zeros(8, dtype=torch.uint8), torch.zeros(9, dtype=torch.uint8)),
    lambda: (torch.zeros(8, dtype=torch.uint8), torch.zeros(8, dtype=torch.uint8, device="meta")),
    lambda: (b"12345678", torch.zeros(8, dtype=torch.uint8)),
], ids=["dtype", "rank", "strided", "size", "device", "not-a-tensor"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src, dst = bad()
    with pytest.raises((TypeError, ValueError)):
        p2p_copy(src, dst)


def test_build_targets_hopper_from_the_package_source():
    assert SOURCE.name == "p2p_copy.cu" and SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    text = SOURCE.read_text()
    # the source names the TPU kernel it replaces and its bound
    assert "_pallas_body" in text and "3.35 TB/s" in text
    assert 'extern "C" int p2p_copy_launch' in text


def _fake_launcher(kern, current=0, rc=0):
    """Bind ``kern`` to a stand-in launcher that records its arguments, so
    the launch path's Python side runs without a card."""
    calls = []
    kern._fn = lambda *args: calls.append(args) or rc
    kern._stream = lambda index: 1000 + index
    kern._current = lambda: current
    return calls


def test_launch_count_is_exact_when_two_threads_launch_at_once():
    kern = P2PCopy()
    _fake_launcher(kern)
    rec = DeviceRecord(0, sms=132)
    per_thread = 20000

    def worker():
        for _ in range(per_thread):
            kern.launch(rec, 1, 2, 16)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kern.launches == 2 * per_thread


def test_launch_enters_the_device_guard_only_off_the_current_device(
        monkeypatch):
    kern = P2PCopy()
    calls = _fake_launcher(kern, current=0)
    entered = []

    @contextlib.contextmanager
    def guard(index):
        entered.append(index)
        yield

    monkeypatch.setattr(cuda_kernel.torch.cuda, "device", guard)
    kern.launch(DeviceRecord(0, sms=132), 7)
    kern.launch(DeviceRecord(1, sms=132), 8)
    assert entered == [1]
    # the stream of the launch's own device rides last
    assert calls == [(7, 1000), (8, 1001)]
    assert kern.launches == 2


def test_refused_launch_raises_and_is_not_counted():
    kern = P2PCopy()
    _fake_launcher(kern, rc=1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kern.launch(DeviceRecord(0, sms=132), 7)
    assert kern.launches == 0
