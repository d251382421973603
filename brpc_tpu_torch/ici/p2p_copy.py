"""p2p_copy: the device plane's byte mover, ``dst[0:n] = src[0:n]`` on uint8.

The hand-written Hopper kernel in ``csrc/p2p_copy.cu`` replaces the TPU
kernel ``DevicePlane._pallas_body.kern`` (brpc_tpu/ici/device_plane.py:
395-444, ``pl.pallas_call`` at :428), the one-hop remote DMA every
device-plane transfer rides.  The source states its bound (bytes:
``2·n / 3.35 TB/s`` on one H100 SXM) and its design.

Build: ``nvcc`` compiles the source into a shared library with a plain C
interface (no PyTorch headers, so it builds in seconds) at first use, into
``_build/`` beside the package, keyed by a hash of the source; ``ctypes``
binds it.  Nothing is compiled or loaded when this module is imported.

:data:`p2p_copy` is the wrapper.  For CPU tensors it runs
:func:`p2p_copy_plain`; for CUDA tensors it launches the kernel on the
current stream or raises — there is no fallback to a library copy.  Its
``launches`` counter grows by one per kernel launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "p2p_copy.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
BLOCKS_PER_SM = 8          # 8 x 256 threads: the SM's 2048 resident threads


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


class P2PCopy:
    """ctypes binding of ``csrc/p2p_copy.cu`` plus its launch counter."""

    def __init__(self):
        self.launches = 0
        self.build_s: Optional[float] = None     # wall time of the build
        self._lib = None
        self._lock = threading.Lock()
        self._max_blocks: Dict[int, int] = {}

    @property
    def built(self) -> bool:
        return self._lib is not None

    def _library_path(self) -> Path:
        digest = hashlib.sha1(SOURCE.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"libp2p_copy-{digest[:16]}.so"

    def build(self) -> float:
        """Compile (when no library for this source exists yet) and load
        the kernel; returns the seconds it took.  Raises on any failure."""
        with self._lock:
            if self._lib is not None:
                return 0.0
            t0 = time.monotonic()
            lib_path = self._library_path()
            if not lib_path.exists():
                self._compile(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            lib.p2p_copy_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_ulonglong, ctypes.c_int,
                                            ctypes.c_void_p]
            lib.p2p_copy_launch.restype = ctypes.c_int
            self._lib = lib
            self.build_s = time.monotonic() - t0
            return self.build_s

    def _compile(self, lib_path: Path) -> None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("p2p_copy: no CUDA toolkit found (nvcc); "
                               "set CUDA_HOME")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"p2p_copy: nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)       # atomic: concurrent builds agree

    def _blocks_cap(self, device: torch.device) -> int:
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        cap = self._max_blocks.get(idx)
        if cap is None:
            sms = torch.cuda.get_device_properties(idx).multi_processor_count
            cap = self._max_blocks[idx] = BLOCKS_PER_SM * sms
        return cap

    def __call__(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """``dst[:] = src`` on the current stream; returns ``dst``."""
        _check(src, dst)
        if src.device.type == "cpu":
            return p2p_copy_plain(src, dst)
        if self._lib is None:
            self.build()
        n = src.numel()
        if n == 0:
            return dst
        device = src.device
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = self._lib.p2p_copy_launch(src.data_ptr(), dst.data_ptr(), n,
                                           self._blocks_cap(device), stream)
        if rc != 0:
            raise RuntimeError(f"p2p_copy: kernel launch failed with CUDA "
                               f"error {rc}")
        with self._lock:
            self.launches += 1
        return dst


p2p_copy = P2PCopy()
