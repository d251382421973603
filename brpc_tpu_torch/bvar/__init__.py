"""bvar — the two counters the serving modules read.

Reference: src/bvar/reducer.h (``Adder``) and latency_recorder.h
(``IntRecorder``), ported from :mod:`brpc_tpu.bvar` without the
write-local agents, windows and the exposed-variable registry: a serving
counter here is read by its owner's ``describe()`` and nothing else, so
one lock per counter keeps read-modify-write exact across threads.
"""
from __future__ import annotations

import threading
from typing import Optional


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
