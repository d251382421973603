"""bvar — the counters the serving and admission modules read.

Reference: src/bvar/reducer.h (``Adder``) and latency_recorder.h
(``IntRecorder``, ``LatencyRecorder``), ported from :mod:`brpc_tpu.bvar`
without the write-local agents, the sampler thread and the
exposed-variable registry: a counter here is read by its owner's
``describe()`` and nothing else, so one lock per variable keeps
read-modify-write exact across threads.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional


def to_underscored_name(name: str) -> str:
    """``"EchoService.Echo"`` → ``"echoservice_echo"``: alphanumerics
    lowered, every other run of characters one underscore, none at the
    ends (the reference's variable-name rule)."""
    out = []
    prev_underscore = False
    for ch in name:
        if ch.isalnum():
            out.append(ch.lower())
            prev_underscore = False
        elif not prev_underscore and out:
            out.append("_")
            prev_underscore = True
    return "".join(out).strip("_")


class Adder:
    """A sum: ``a << v`` adds ``v``; ``get_value()`` reads it."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: Optional[str] = None, identity=0):
        self.name = name
        self._value = identity
        self._lock = threading.Lock()

    def __lshift__(self, value) -> "Adder":
        with self._lock:
            self._value += value
        return self

    def get_value(self):
        with self._lock:
            return self._value


class IntRecorder:
    """Average of recorded ints: ``r << v`` records ``v``."""

    __slots__ = ("name", "_sum", "_count", "_lock")

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self._sum = 0
        self._count = 0
        self._lock = threading.Lock()

    def __lshift__(self, value: int) -> "IntRecorder":
        with self._lock:
            self._sum += int(value)
            self._count += 1
        return self

    def average(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def get_value(self) -> float:
        return self.average()


class LatencyRecorder:
    """Latency in microseconds over a sliding window: ``rec << us``
    records one call.  ``count()`` and ``max_latency()`` cover every
    record; ``latency()`` (the mean), ``qps()`` and
    ``latency_percentile(ratio)`` cover the last ``window_size`` seconds
    (the reference's default window).  The window keeps at most
    ``MAX_SAMPLES`` records, the newest, for its percentiles."""

    MAX_SAMPLES = 4096

    def __init__(self, name: Optional[str] = None, window_size: int = 10):
        self.name = name
        self.window_s = float(window_size)
        self._samples = collections.deque(maxlen=self.MAX_SAMPLES)
        self._count = 0
        self._sum = 0
        self._max = 0
        self._lock = threading.Lock()

    def __lshift__(self, latency_us: int) -> "LatencyRecorder":
        latency_us = int(latency_us)
        now = time.monotonic()
        with self._lock:
            self._samples.append((now, latency_us))
            self._count += 1
            self._sum += latency_us
            if latency_us > self._max:
                self._max = latency_us
        return self

    def _window(self):
        cutoff = time.monotonic() - self.window_s
        with self._lock:
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            return [v for _, v in self._samples]

    def count(self) -> int:
        with self._lock:
            return self._count

    def max_latency(self) -> int:
        with self._lock:
            return self._max

    def latency(self) -> float:
        """Mean latency (µs) of the records in the window."""
        vals = self._window()
        return sum(vals) / len(vals) if vals else 0.0

    def qps(self) -> float:
        """Records per second over the window."""
        return len(self._window()) / self.window_s

    def latency_percentile(self, ratio: float) -> int:
        vals = sorted(self._window())
        if not vals:
            return 0
        return vals[min(int(ratio * len(vals)), len(vals) - 1)]

    def get_value(self) -> float:
        return self.latency()
