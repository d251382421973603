"""p2p_copy: the device plane's byte mover, ``dst[0:n] = src[0:n]`` on uint8.

The hand-written Hopper kernel in ``csrc/p2p_copy.cu`` replaces the TPU
kernel ``DevicePlane._pallas_body.kern`` (brpc_tpu/ici/device_plane.py:
395-444, ``pl.pallas_call`` at :428), the one-hop remote DMA every
device-plane transfer rides.  The source states its bound (bytes:
``2·n / 3.35 TB/s`` on one H100 SXM), its design and the candidates it
was measured against (``sweeps/``, outside the package).

Build and binding: :class:`~.cuda_kernel.CudaKernel` (``nvcc`` at first
use into ``_build/``, ``ctypes``).

:data:`p2p_copy` is the wrapper.  For CPU tensors it runs
:func:`p2p_copy_plain`; for CUDA tensors it launches the kernel on the
current stream or raises — there is no fallback to a library copy.  Its
``launches`` counter grows by one per kernel launch and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_kernel import CSRC, NVCC_FLAGS, CudaKernel  # noqa: F401

SOURCE = CSRC / "p2p_copy.cu"

_U8 = torch.uint8


def p2p_copy_plain(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the same function as the kernel."""
    dst.copy_(src)
    return dst


def _check(src, dst) -> int:
    """The CUDA device index of a pair of tensors on one card, or -1 for a
    pair on the CPU; raises TypeError or ValueError on what the kernel does
    not take.  The accepted case costs one chained test."""
    if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src.dtype is _U8 and dst.dtype is _U8 and src.dim() == 1
            and src.shape == dst.shape and src.is_contiguous()
            and dst.is_contiguous()):
        if src.is_cuda:
            index = src.get_device()
            if dst.is_cuda and dst.get_device() == index:
                return index
        elif src.is_cpu and dst.is_cpu:
            return -1
    _refuse(src, dst)


def _refuse(src, dst) -> None:
    """Raise the error that names what is wrong with the pair."""
    for name, t in (("src", src), ("dst", dst)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"p2p_copy: {name} must be a tensor")
        if t.dtype != _U8 or t.dim() != 1:
            raise TypeError(f"p2p_copy: {name} must be a flat uint8 tensor, "
                            f"got {t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"p2p_copy: {name} must be contiguous")
    if src.numel() != dst.numel():
        raise ValueError(f"p2p_copy: size mismatch {src.numel()} -> "
                         f"{dst.numel()}")
    if src.device != dst.device:
        raise ValueError(f"p2p_copy: src on {src.device}, dst on "
                         f"{dst.device}; the kernel copies within one device")
    raise ValueError(f"p2p_copy: unsupported device {src.device}")


class P2PCopy(CudaKernel):
    """``csrc/p2p_copy.cu`` and its launch counter."""

    def __init__(self):
        super().__init__(SOURCE, "p2p_copy_launch",
                         [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_ulonglong])

    def __call__(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """``dst[:] = src`` on the current stream; returns ``dst``."""
        index = _check(src, dst)
        if index < 0:
            return p2p_copy_plain(src, dst)
        n = src.numel()
        if n:
            rec = self._records.get(index) or self.record(index)
            self.launch(rec, src.data_ptr(), dst.data_ptr(), n)
        return dst


p2p_copy = P2PCopy()
