"""Profiling: CPU hotspots, lock contention and the card's trace.

Reference: src/brpc/builtin/hotspots_service.cpp (gperftools
ProfilerStart, pprof rendering) and the contention profiler of
src/bthread/mutex.cpp:107-313, ported from :mod:`brpc_tpu.rpc.profiler`:

  * CPU hotspots: cProfile started and stopped around a window
    (:func:`profile_for`) or one call (:func:`profile_call`, or
    :func:`profile_stats` for the raw statistics), rendered as text sorted
    by cumulative time; the /hotspots and /pprof/profile pages serve it
    with ``?seconds=N``;
  * contention: a :class:`ContentionMutex` samples its contended
    acquisitions above a floor (speed-limited through the bvar
    collector) with the blocking call site, summed into a profile
    (:func:`contention_profile`), the reference's bthread_mutex hook;
  * the card: :func:`start_device_trace` / :func:`stop_device_trace` run
    ``torch.profiler`` with the CUDA activity (and the CPU one) and write
    a Chrome trace into a directory, where the JAX package runs
    ``jax.profiler``.
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import threading
import time
import traceback
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .. import bvar

# ---- CPU hotspots -----------------------------------------------------

_profile_lock = threading.Lock()


def profile_for(seconds: float = 1.0, top: int = 40) -> str:
    """Profile the process for ``seconds`` and render its hotspots.  The
    lock serializes profilers over cProfile's process-wide hook; the
    sleep is the sampled window."""
    with _profile_lock:
        pr = cProfile.Profile()
        pr.enable()
        time.sleep(seconds)  # fablint: ignore[blocking-under-lock] the lock serializes the process-global profiler; the sleep is the sampling window itself
        pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("cumulative").print_stats(top)
    return out.getvalue()


def profile_stats(fn, *args, **kwargs) -> Tuple[object, pstats.Stats]:
    """``fn(*args, **kwargs)`` under cProfile: its result and the raw
    ``pstats.Stats`` (for comparing two runs function by function).
    cProfile sees the calling thread only."""
    pr = cProfile.Profile()
    pr.enable()
    try:
        result = fn(*args, **kwargs)
    finally:
        pr.disable()
    return result, pstats.Stats(pr)


def profile_call(fn, *args, top: int = 40, **kwargs) -> Tuple[object, str]:
    """``fn(*args, **kwargs)`` under cProfile: its result and the
    rendered hotspots."""
    result, stats = profile_stats(fn, *args, **kwargs)
    out = io.StringIO()
    stats.stream = out
    stats.sort_stats("cumulative").print_stats(top)
    return result, out.getvalue()


# ---- contention profiler ---------------------------------------------

_contention_enabled = False
_contention_limit = bvar.CollectorSpeedLimit(max_samples_per_second=200)
_contention_lock = threading.Lock()
_contention_samples: Dict[str, List[float]] = defaultdict(list)
contention_sample_count = bvar.Adder("lock_contention_samples")

CONTENTION_FLOOR_US = 50        # waits shorter than this are never sampled


def enable_contention_profiler(enabled: bool = True) -> None:
    global _contention_enabled
    _contention_enabled = enabled
    if not enabled:
        with _contention_lock:
            _contention_samples.clear()


def contention_enabled() -> bool:
    return _contention_enabled


def contention_profile() -> List[Tuple[str, int, float]]:
    """(call site, samples, total wait s), the longest total first."""
    with _contention_lock:
        rows = [(site, len(waits), sum(waits))
                for site, waits in _contention_samples.items()]
    return sorted(rows, key=lambda r: -r[2])


def _record_contention(wait_s: float) -> None:
    if not _contention_limit.is_sampled():
        return
    # the blocking call site: the first frame outside this module
    stack = traceback.extract_stack(limit=6)
    site = "?"
    for frame in reversed(stack):
        if "profiler.py" not in frame.filename:
            site = f"{frame.filename}:{frame.lineno} {frame.name}"
            break
    with _contention_lock:
        _contention_samples[site].append(wait_s)
    contention_sample_count << 1


class ContentionMutex:
    """A mutex whose contended acquisitions feed the contention profiler
    (reference bthread_mutex with its sampling, mutex.cpp:107)."""

    def __init__(self):
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float] = None) -> bool:
        if self._lock.acquire(blocking=False):
            return True
        t0 = time.monotonic()
        ok = self._lock.acquire(timeout=timeout if timeout is not None else -1)
        wait = time.monotonic() - t0
        if _contention_enabled and wait * 1e6 >= CONTENTION_FLOOR_US:
            _record_contention(wait)
        return ok

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "ContentionMutex":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ---- the card's trace (torch.profiler) --------------------------------

_trace_lock = threading.Lock()
_trace: Optional[tuple] = None          # (profiler, log_dir)


def start_device_trace(log_dir: str) -> bool:
    """Start ``torch.profiler`` over the CPU and, when a card is present,
    CUDA activities; :func:`stop_device_trace` writes the trace into
    ``log_dir``.  False when a trace runs already or the profiler cannot
    start."""
    global _trace
    with _trace_lock:
        if _trace is not None:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        except Exception:
            return False
        _trace = (prof, log_dir)
        return True


def stop_device_trace() -> bool:
    """Stop the trace started by :func:`start_device_trace` and write it
    as ``trace.<pid>.<ms>.json`` into its directory.  False when none
    runs or the write fails."""
    global _trace
    with _trace_lock:
        if _trace is None:
            return False
        prof, log_dir = _trace
        _trace = None
    try:
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{int(time.time() * 1000)}.json"))
        return True
    except Exception:
        return False
