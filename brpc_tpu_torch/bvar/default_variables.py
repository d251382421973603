"""Process and system metrics read from /proc (reference:
src/bvar/default_variables.cpp), plus the card's and the ici:// fabric's.

Port of :mod:`brpc_tpu.bvar.default_variables`.  Exposed on first use by
:func:`expose_default_variables` (the reference exposes them at static
init; deferring keeps importing the package cheap).  The JAX package's
``tpu_device_count``/``tpu_hbm_bytes_in_use`` become ``cuda_device_count``
and ``cuda_memory_bytes_in_use`` (the caching allocator's bytes in use on
device 0; 0 without a card).
"""
from __future__ import annotations

import os
import resource
import threading
import time
from typing import List

from .variable import PassiveStatus, Variable

_exposed: List[Variable] = []
_lock = threading.Lock()
_start_time = time.time()


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except Exception:
        return -1


def _thread_count() -> int:
    return threading.active_count()


def _cpu_seconds() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _cuda_device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _cuda_memory_bytes() -> int:
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated(0))


def _ici_bytes_moved() -> int:
    from ..ici.transport import ici_transport_stats
    return ici_transport_stats()[0]


def _ici_device_bytes_moved() -> int:
    from ..ici.transport import ici_transport_stats
    return ici_transport_stats()[1]


def _ici_refs_in_custody() -> int:
    """Device refs held for the native ici plane (0 unless a call is in
    flight: a steady nonzero value is a custody leak)."""
    from ..ici import native_plane
    return native_plane.registry().live()


def expose_default_variables() -> None:
    with _lock:
        if _exposed:
            return
        _exposed.extend([
            PassiveStatus(lambda: os.getpid(), "process_pid"),
            PassiveStatus(lambda: time.time() - _start_time,
                          "process_uptime"),
            PassiveStatus(_rss_bytes, "process_memory_resident"),
            PassiveStatus(_fd_count, "process_fd_count"),
            PassiveStatus(_thread_count, "process_thread_count"),
            PassiveStatus(_cpu_seconds, "process_cpu_seconds"),
            PassiveStatus(_cuda_device_count, "cuda_device_count"),
            PassiveStatus(_cuda_memory_bytes, "cuda_memory_bytes_in_use"),
            PassiveStatus(_ici_bytes_moved, "ici_bytes_moved"),
            PassiveStatus(_ici_device_bytes_moved, "ici_device_bytes_moved"),
            PassiveStatus(_ici_refs_in_custody, "ici_refs_in_custody"),
        ])
