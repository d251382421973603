"""p2p_copy: the device plane's byte mover, ``dst[0:n] = src[0:n]`` on uint8.

The hand-written Hopper kernel in ``csrc/p2p_copy.cu`` replaces the TPU
kernel ``DevicePlane._pallas_body.kern`` (brpc_tpu/ici/device_plane.py:
395-444, ``pl.pallas_call`` at :428), the one-hop remote DMA every
device-plane transfer rides.  The source states its bound (bytes:
``2·n / 3.35 TB/s`` on one H100 SXM) and its design.

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


def p2p_copy_plain(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the same function as the kernel."""
    dst.copy_(src)
    return dst


def _check(src: torch.Tensor, dst: torch.Tensor) -> None:
    for name, t in (("src", src), ("dst", dst)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"p2p_copy: {name} must be a tensor")
        if t.dtype != torch.uint8 or t.dim() != 1:
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
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"p2p_copy: unsupported device {src.device}")


class P2PCopy(CudaKernel):
    """``csrc/p2p_copy.cu`` and its launch counter."""

    def __init__(self):
        super().__init__(SOURCE, "p2p_copy_launch",
                         [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_ulonglong, ctypes.c_int])

    def __call__(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """``dst[:] = src`` on the current stream; returns ``dst``."""
        _check(src, dst)
        if src.device.type == "cpu":
            return p2p_copy_plain(src, dst)
        n = src.numel()
        if n == 0:
            return dst
        self.launch(src.device, src.data_ptr(), dst.data_ptr(), n,
                    self.blocks_cap(src.device))
        return dst


p2p_copy = P2PCopy()
