"""TimerThread: O(log n) schedule, lazy unschedule, one daemon thread.

Reference: src/bthread/timer_thread.{h,cpp} (schedule/unschedule at
timer_thread.h:74-82).  Runs RPC deadlines and backup-request triggers.  The
reference hashes timers into buckets to cut lock contention; a single binary
heap is the right shape at Python scale, with the same observable semantics:
``unschedule`` of a not-yet-run timer prevents it from firing and drops its
callback at once (the heap keeps only the id, skipped when it surfaces):
a cancelled deadline must not keep its call's Controller, and with it the
call's device attachment, alive until the deadline would have passed.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, Optional

TimerId = int


class TimerThread:
    _instance: Optional["TimerThread"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._heap: list = []                         # (abstime, id)
        self._entries: Dict[TimerId, Callable[[], None]] = {}  # live ones
        self._next_id = itertools.count(1)
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    @classmethod
    def instance(cls) -> "TimerThread":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = TimerThread()
            return cls._instance

    def schedule(self, fn: Callable[[], None], abstime: float) -> TimerId:
        """abstime is time.monotonic()-based."""
        with self._cv:
            tid = next(self._next_id)
            heapq.heappush(self._heap, (abstime, tid))
            self._entries[tid] = fn
            if self._thread is None:
                # fablint: thread-quiesced(process-lifetime singleton; parks on its condvar between timers)
                self._thread = threading.Thread(
                    target=self._run, name="brpc_timer", daemon=True)
                self._thread.start()
            self._cv.notify()
            return tid

    def schedule_after(self, fn: Callable[[], None], delay_s: float) -> TimerId:
        return self.schedule(fn, time.monotonic() + delay_s)

    def unschedule(self, tid: TimerId) -> int:
        """0 if prevented from running, 1 if already run/unknown."""
        with self._cv:
            return 0 if self._entries.pop(tid, None) is not None else 1

    def _run(self) -> None:
        while not self._stop:
            with self._cv:
                now = time.monotonic()
                while self._heap and (self._heap[0][0] <= now
                                      or self._heap[0][1] not in self._entries):
                    _, tid = heapq.heappop(self._heap)
                    fn = self._entries.pop(tid, None)
                    if fn is None:
                        continue
                    self._cv.release()
                    try:
                        self._fire(fn)
                    finally:
                        fn = None     # parked, hold no fired callback
                        self._cv.acquire()
                    now = time.monotonic()
                wait = None
                if self._heap:
                    wait = max(0.0, self._heap[0][0] - now)
                self._cv.wait(wait if wait is not None else 1.0)

    @staticmethod
    def _fire(fn: Callable[[], None]) -> None:
        from . import scheduler
        # timers run in tasklets so a slow callback can't delay the wheel
        scheduler.start_urgent(fn, name="timer_cb")


def timer_add(fn: Callable[[], None], delay_s: float) -> TimerId:
    return TimerThread.instance().schedule_after(fn, delay_s)


def timer_del(tid: TimerId) -> int:
    return TimerThread.instance().unschedule(tid)
