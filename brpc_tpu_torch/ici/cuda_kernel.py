"""CudaKernel: build, bind and count one hand-written CUDA kernel.

Every kernel of the port lives in one source under ``csrc/`` with a plain
C interface (no PyTorch headers, so ``nvcc`` takes seconds).  At first use
``nvcc`` compiles it for ``sm_90a`` into a shared library under ``_build/``
beside the package, named by a hash of the source and the flags, and
``ctypes`` binds its launcher.  Nothing is compiled or loaded when a module
is imported.

Each launcher takes its arguments and, last, the CUDA stream, and returns
``cudaGetLastError()`` after the launch.  :meth:`CudaKernel.launch` calls it
on the current stream of a device, raises on a non-zero code and adds one
to ``launches``: the count a run reads to show that its path went through
the kernel.  The launch path is lean because the device plane launches
once per transfer: one :class:`DeviceRecord` per device is cached (SM
count, grid cap), the current stream's raw handle is read once per call,
and the device guard is entered only when the launch targets a device
other than the current one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
BLOCKS_PER_SM = 8          # 8 x 256 threads: the SM's 2048 resident threads


class DeviceRecord:
    """What a launch needs to know of one device, looked up once."""

    __slots__ = ("index", "sms", "blocks_cap")

    def __init__(self, index: int, sms: int):
        self.index = index
        self.sms = sms
        self.blocks_cap = BLOCKS_PER_SM * sms   # fills every SM (256 threads)


class CudaKernel:
    """The library built from ``source`` and the launch counter of its
    wrapper.  ``launcher`` names the C function and ``argtypes`` its
    arguments before the trailing stream."""

    def __init__(self, source: Path, launcher: str, argtypes: List):
        self.source = Path(source)
        self.launcher = launcher
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_s: Optional[float] = None     # wall time of the build
        self._fn = None
        self._lock = threading.Lock()
        self._records: Dict[int, DeviceRecord] = {}
        self._stream = None
        self._current = None

    @property
    def name(self) -> str:
        return self.source.stem

    @property
    def built(self) -> bool:
        return self._fn is not None

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"

    def build(self) -> float:
        """Compile (when no library for this source exists yet) and load
        the kernel; returns the seconds it took.  Raises on any failure."""
        with self._lock:
            if self._fn is not None:
                return 0.0
            t0 = time.monotonic()
            lib_path = self.library_path()
            if not lib_path.exists():
                self._compile(lib_path)
            fn = getattr(ctypes.CDLL(str(lib_path)), self.launcher)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            # PyTorch's own kernel launchers read the current stream's raw
            # handle and the current device this way: no Stream object is
            # built and no lazy-init check runs (a launch follows tensors
            # already on the card)
            self._stream = torch._C._cuda_getCurrentRawStream
            self._current = torch._C._cuda_getDevice
            self._fn = fn
            self.build_s = time.monotonic() - t0
            return self.build_s

    def _compile(self, lib_path: Path) -> None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError(f"{self.name}: no CUDA toolkit found (nvcc); "
                               "set CUDA_HOME")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                   ".tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{self.name}: nvcc failed ({proc.returncode})"
                               f":\n{proc.stderr}")
        os.replace(tmp, lib_path)       # atomic: concurrent builds agree

    def record(self, index: int) -> DeviceRecord:
        """The cached record of CUDA device ``index``; the first call
        builds the kernel if needed."""
        rec = self._records.get(index)
        if rec is not None:
            return rec
        if self._fn is None:
            self.build()
        with self._lock:
            rec = self._records.get(index)
            if rec is None:
                sms = torch.cuda.get_device_properties(index) \
                    .multi_processor_count
                rec = DeviceRecord(index, sms)
                self._records[index] = rec
        return rec

    def launch(self, rec: DeviceRecord, *args) -> None:
        """Run the launcher with ``args`` on the current stream of
        ``rec``'s device; raise if CUDA refused the launch, else count it."""
        index = rec.index
        stream = self._stream(index)
        if self._current() == index:
            rc = self._fn(*args, stream)
        else:
            with torch.cuda.device(index):
                rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA "
                               f"error {rc}")
        with self._lock:
            self.launches += 1
