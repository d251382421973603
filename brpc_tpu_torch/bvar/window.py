"""Window and PerSecond over reducers, driven by one sampler thread.

Reference: src/bvar/window.h and detail/sampler.{h,cpp}, ported from
:mod:`brpc_tpu.bvar.window`.  One daemon thread per process ticks once a
second and snapshots every registered reducer into a ring of samples;
``Window(reducer, N)`` reports the change over the last N ticks and
``PerSecond`` divides it by the span those ticks cover.  Tests drive the
tick themselves with ``SamplerCollector.instance().sample_once()``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from .variable import Variable
from .reducer import Reducer

_MAX_WINDOW = 120


class _ReducerSampler:
    def __init__(self, reducer: Reducer, window_size: int):
        self.reducer = reducer
        self.window_size = max(window_size, 1)
        self.samples: Deque[Tuple[float, object]] = deque(
            maxlen=_MAX_WINDOW + 1)
        self._version = None

    def take_sample(self) -> None:
        """Snapshot the reducer.  A reducer whose combine is costly (a
        Percentile's reservoir merge) reports a version; while it is
        unchanged since the last tick, the last snapshot is repeated
        instead of combining again, so idle recorders cost the sampler
        thread next to nothing."""
        version_fn = getattr(self.reducer, "version", None)
        if version_fn is not None:
            version = version_fn()
            if version == self._version and self.samples:
                self.samples.append((time.monotonic(), self.samples[-1][1]))
                return
            self._version = version
        self.samples.append((time.monotonic(), self.reducer.get_value()))

    def value_in_window(self, window_size: int):
        """The newest sample minus the one ``window_size`` ticks back (an
        invertible op, e.g. Adder), or the combination of the samples
        inside the window (max/min); with the span they cover."""
        if not self.samples:
            return self.reducer._identity, 0.0
        newest_t, newest_v = self.samples[-1]
        idx = max(0, len(self.samples) - 1 - window_size)
        oldest_t, oldest_v = self.samples[idx]
        span = newest_t - oldest_t
        if self.reducer.inv_op is not None:
            return self.reducer.inv_op(newest_v, oldest_v), span
        vals = [v for _, v in list(self.samples)[idx:]]
        acc = vals[0]
        for v in vals[1:]:
            acc = self.reducer.op(acc, v)
        return acc, span


class SamplerCollector:
    """The once-a-second sampling thread (detail/sampler.cpp)."""

    _instance: Optional["SamplerCollector"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._samplers: List[_ReducerSampler] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @classmethod
    def instance(cls) -> "SamplerCollector":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = SamplerCollector()
            return cls._instance

    def register(self, sampler: _ReducerSampler) -> None:
        with self._lock:
            self._samplers.append(sampler)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="bvar_sampler", daemon=True)
                self._thread.start()

    def unregister(self, sampler: _ReducerSampler) -> None:
        with self._lock:
            try:
                self._samplers.remove(sampler)
            except ValueError:
                pass

    def _run(self) -> None:
        while not self._stop.wait(1.0):
            self.sample_once()

    def sample_once(self) -> None:
        """One tick; tests call it directly instead of sleeping."""
        with self._lock:
            samplers = list(self._samplers)
        for s in samplers:
            try:
                s.take_sample()
            except Exception:
                pass


class Window(Variable):
    """The value accumulated over the last ``window_size`` ticks."""

    def __init__(self, reducer: Reducer, window_size: int = 10,
                 name: Optional[str] = None):
        self._sampler = _ReducerSampler(reducer, window_size)
        self._sampler.take_sample()
        SamplerCollector.instance().register(self._sampler)
        self._window_size = window_size
        super().__init__(name)

    def get_value(self):
        v, _ = self._sampler.value_in_window(self._window_size)
        return v

    def get_span(self) -> float:
        _, span = self._sampler.value_in_window(self._window_size)
        return span

    def window_size(self) -> int:
        return self._window_size

    def __del__(self):
        try:
            SamplerCollector.instance().unregister(self._sampler)
        except Exception:
            pass
        super().__del__()


class PerSecond(Window):
    """The windowed value over the real seconds it spans (reference
    bvar::PerSecond)."""

    def get_value(self):
        v, span = self._sampler.value_in_window(self._window_size)
        if span <= 0:
            return 0
        return v / span
