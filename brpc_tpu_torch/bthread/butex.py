"""Butex: the futex-like foundation of every blocking primitive.

Reference: src/bthread/butex.{h,cpp} (butex_create/wait/wake at butex.cpp:244,
637, 283).  A butex is a 32-bit word plus a waiter list; ``wait(expected)``
blocks only if the word still equals ``expected`` when the waiter is queued
(the atomicity that kills lost-wakeup races), and wakers move waiters back to
run queues.

Here tasklets are carried by worker threads (see scheduler.py), so a butex
parks the carrying thread on a per-butex condition variable — same contract,
same lost-wakeup guarantee, with the scheduler notified so it can keep the
pool from starving (the analogue of bthread's "workers never block" rule is
"blocked workers are compensated").
"""
from __future__ import annotations

import threading
import time
from typing import Optional

ETIMEDOUT = 110
EWOULDBLOCK = 11


class Butex:
    __slots__ = ("_value", "_cond", "_waiters")

    def __init__(self, value: int = 0):
        self._value = value
        self._cond = threading.Condition()
        self._waiters = 0

    # -- value ops (all under the condition lock = "atomic word") ------
    @property
    def value(self) -> int:
        with self._cond:
            return self._value

    def set_value(self, value: int) -> None:
        with self._cond:
            self._value = value

    def fetch_add(self, delta: int) -> int:
        with self._cond:
            old = self._value
            self._value += delta
            return old

    # -- wait/wake -----------------------------------------------------
    def wait(self, expected: int, timeout: Optional[float] = None) -> int:
        """Block while value == expected.  Returns 0, EWOULDBLOCK if the
        value changed before queuing, or ETIMEDOUT."""
        from . import scheduler
        with self._cond:
            if self._value != expected:
                return EWOULDBLOCK
            self._waiters += 1
            scheduler.note_worker_blocked()
            try:
                deadline = None if timeout is None else time.monotonic() + timeout
                while self._value == expected:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return ETIMEDOUT
                    self._cond.wait(remaining)
                return 0
            finally:
                self._waiters -= 1
                scheduler.note_worker_unblocked()

    def wake_all(self) -> int:
        with self._cond:
            woken = self._waiters
            self._cond.notify_all()
            return woken

    def wake_all_and_set(self, value: int) -> int:
        """Atomically store value and wake everyone (the completion
        pattern)."""
        with self._cond:
            self._value = value
            woken = self._waiters
            self._cond.notify_all()
            return woken
