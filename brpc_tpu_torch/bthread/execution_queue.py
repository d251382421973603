"""ExecutionQueue: MPSC serialized executor.

Reference: src/bthread/execution_queue.{h,cpp} (execution_queue_start /
execute at execution_queue.h:159-196), ported from
:mod:`brpc_tpu.bthread.execution_queue`.  Tasks submitted from any thread
are executed *in order, by at most one consumer at a time*; the first
submitter to an idle queue spawns the consumer on the scheduler, so there
is no thread per queue.  The stream's delivery path runs on it.

The handler receives an iterator over a batch of tasks, like the
reference's TaskIterator; a batch that holds the stop mark ends the queue
once it is consumed.  The consumer lets go of each batch before it waits
for the next: a delivered batch may hold a received tensor, which must be
freed as soon as the handler is done with it.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Deque, Generic, List, Optional, TypeVar

from . import scheduler

T = TypeVar("T")

_STOP = object()


class TaskIterator(Generic[T]):
    def __init__(self, batch: List[Any]):
        self._batch = batch
        self._i = 0
        self.stopped = False

    def __iter__(self) -> "TaskIterator[T]":
        return self

    def __next__(self) -> T:
        while self._i < len(self._batch):
            item = self._batch[self._i]
            self._i += 1
            if item is _STOP:
                self.stopped = True
                continue
            return item
        raise StopIteration


class ExecutionQueue(Generic[T]):
    """``linger_s > 0``: a drained consumer waits this long for more work
    before it retires, so a steady serial producer (a stream's frames)
    does not pay a tasklet spawn per task."""

    def __init__(self, handler: Callable[[TaskIterator[T]], None],
                 linger_s: float = 0.0):
        self._handler = handler
        self._queue: Deque[Any] = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._consuming = False
        self._stopped = False
        self._joined = threading.Event()
        self._linger = linger_s

    def execute(self, task: T) -> int:
        return self._push(task)

    def stop(self) -> int:
        """No more tasks accepted; queued ones still run (reference
        execution_queue_stop)."""
        return self._push(_STOP, is_stop=True)

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._joined.wait(timeout)

    def _push(self, item: Any, is_stop: bool = False) -> int:
        become_consumer = False
        with self._lock:
            if self._stopped:
                return 22  # EINVAL
            if is_stop:
                self._stopped = True
            self._queue.append(item)
            self._cv.notify()
            if not self._consuming:
                self._consuming = True
                become_consumer = True
        if become_consumer:
            scheduler.start_background(self._consume, name="execq")
        return 0

    def _consume(self) -> None:
        while True:
            with self._lock:
                if not self._queue and self._linger and not self._stopped:
                    self._cv.wait(self._linger)
                if not self._queue:
                    self._consuming = False
                    if self._stopped:
                        self._joined.set()
                    return
                batch = list(self._queue)
                self._queue.clear()
            it = TaskIterator(batch)
            del batch
            try:
                self._handler(it)
            except Exception:
                from ..butil import logging as log
                log.error("ExecutionQueue handler raised", exc_info=True)
            # drain what the handler left (it may return early) without
            # binding an item to a local
            collections.deque(it, maxlen=0)
            stopped = it.stopped
            del it                       # hold no delivered task
            if stopped:
                with self._lock:
                    self._consuming = False
                self._joined.set()
                return


def execution_queue_start(handler: Callable[[TaskIterator[T]], None]
                          ) -> ExecutionQueue[T]:
    return ExecutionQueue(handler)
