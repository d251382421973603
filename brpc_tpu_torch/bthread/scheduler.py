"""M:N tasklet scheduler: TaskControl + per-worker TaskGroups with stealing.

Reference: src/bthread/task_control.{h,cpp} + task_group.{h,cpp}.  The
reference multiplexes bthreads over N pthread workers with per-worker
work-stealing deques, a remote queue for submissions from non-workers, and
ParkingLot futexes for idle-worker signaling; ``start_urgent`` runs the new
bthread immediately for cache locality (task_group.cpp:361) while
``start_background`` queues it (task_group.cpp:420).

TPU-native translation: tasklets are Python callables carried by a worker
pool.  CPython cannot switch stacks, so "urgent" maps to LIFO dispatch on the
submitting worker's own deque (next thing it or a thief runs) and blocking
primitives park the carrying worker, with *compensation*: whenever every
worker is blocked inside a butex and runnable work exists, the pool grows one
worker (bounded), preserving the reference's core liveness property that a
blocked request never wedges unrelated requests (docs/en/io.md tail-latency
doctrine).  The hard-latency datapath belongs to the C++ core (native/),
which implements real fibers; this scheduler is the orchestration layer
driving it and the device plane.

At interpreter exit the workers are stopped and joined (``quiesce``, an
``atexit`` hook): a daemon worker still inside a torch call when the
interpreter finalizes is unwound through C++ frames that cannot unwind,
and the process aborts ("terminate called without an active exception")
whatever exit code it was leaving with.
"""
from __future__ import annotations

import atexit
import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from ..butil.resource_pool import ResourcePool
from ..butil import flags as _flags

_flags.define_flag("bthread_concurrency", 4,
                   "number of scheduler worker threads",
                   _flags.positive_integer)
_flags.define_flag("bthread_max_concurrency", 64,
                   "cap on compensated workers", _flags.positive_integer)


class Tasklet:
    __slots__ = ("fn", "args", "kwargs", "tid", "name", "local_storage")

    def __init__(self, fn: Callable, args: tuple, kwargs: dict,
                 name: Optional[str] = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.tid = 0
        self.name = name
        # bthread-locals (key.cpp), made on the first local_set
        self.local_storage: Optional[Dict[str, Any]] = None


_tls = threading.local()


class TaskGroup:
    """Per-worker run queue (work_stealing_queue.h + remote_task_queue.h)."""

    def __init__(self, control: "TaskControl", index: int):
        self.control = control
        self.index = index
        self.deque: Deque[Tasklet] = collections.deque()
        self.lock = threading.Lock()

    def push_urgent(self, t: Tasklet) -> None:
        with self.lock:
            self.deque.appendleft(t)

    def push_background(self, t: Tasklet) -> None:
        with self.lock:
            self.deque.append(t)

    def pop_local(self) -> Optional[Tasklet]:
        with self.lock:
            return self.deque.popleft() if self.deque else None

    def steal(self) -> Optional[Tasklet]:
        """Victims are stolen from the tail (FIFO side), reference
        WorkStealingQueue::steal."""
        with self.lock:
            return self.deque.pop() if self.deque else None


class TaskControl:
    _instance: Optional["TaskControl"] = None
    _instance_lock = threading.Lock()

    def __init__(self, concurrency: Optional[int] = None):
        self.concurrency = concurrency or _flags.get_flag("bthread_concurrency")
        self.groups: List[TaskGroup] = []
        self.pool: ResourcePool = ResourcePool()
        self._parking = threading.Condition()     # ParkingLot
        self._pending_signal = 0
        self._workers: List[threading.Thread] = []
        self._blocked_workers = 0
        self._blocked_lock = threading.Lock()
        self._stop = False
        self._next_victim = 0
        for i in range(self.concurrency):
            self._add_worker(i)

    @classmethod
    def instance(cls) -> "TaskControl":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = TaskControl()
                atexit.register(cls._instance.quiesce)
            return cls._instance

    def quiesce(self, timeout: float = 2.0) -> bool:
        """Stop the workers: each finishes the tasklet it runs and exits;
        queued tasklets are dropped.  Waits at most ``timeout`` seconds in
        all; True when every worker (other than the caller) has exited."""
        self._stop = True
        with self._parking:
            self._parking.notify_all()
        deadline = time.monotonic() + timeout
        me = threading.current_thread()
        for t in list(self._workers):
            if t is not me:
                t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._workers if t is not me)

    # -- workers -------------------------------------------------------
    def _add_worker(self, index: int) -> None:
        g = TaskGroup(self, index)
        self.groups.append(g)
        t = threading.Thread(target=self._worker_main, args=(g,),
                             name=f"bthread_worker_{index}", daemon=True)
        self._workers.append(t)
        t.start()

    def _worker_main(self, group: TaskGroup) -> None:
        _tls.group = group
        while not self._stop:
            task = group.pop_local() or self._steal_task(group)
            if task is None:
                with self._parking:
                    if self._pending_signal > 0:
                        self._pending_signal -= 1
                        continue
                    self._parking.wait(timeout=0.5)
                continue
            self._run_task(task)

    def _steal_task(self, thief: TaskGroup) -> Optional[Tasklet]:
        n = len(self.groups)
        start = self._next_victim
        self._next_victim = (start + 1) % max(n, 1)
        for i in range(n):
            victim = self.groups[(start + i) % n]
            if victim is thief:
                continue
            t = victim.steal()
            if t is not None:
                return t
        return None

    def _run_task(self, task: Tasklet) -> None:
        _tls.current = task
        try:
            task.fn(*task.args, **task.kwargs)
        except Exception:
            from ..butil import logging as log
            log.error("tasklet %s raised", task.name, exc_info=True)
        finally:
            _tls.current = None
            self.pool.return_resource(task.tid)
            # an idle worker still holds its last tasklet: drop what it
            # ran on (a request's frame, and so its device attachment)
            task.fn = task.args = task.kwargs = None
            task.local_storage = None

    # -- submission (signal_task / steal_task of the reference) --------
    def submit(self, task: Tasklet, urgent: bool) -> int:
        task.tid = self.pool.get_resource(task)
        group: Optional[TaskGroup] = getattr(_tls, "group", None)
        if group is not None:
            (group.push_urgent if urgent else group.push_background)(task)
        else:
            # remote submission: round-robin a group's FIFO side
            victim = self.groups[task.tid % len(self.groups)]
            victim.push_background(task)
        with self._parking:
            self._pending_signal += 1
            self._parking.notify()
        self._maybe_compensate()
        return task.tid

    # -- blocked-worker compensation ----------------------------------
    def note_blocked(self) -> None:
        with self._blocked_lock:
            self._blocked_workers += 1
        self._maybe_compensate()

    def note_unblocked(self) -> None:
        with self._blocked_lock:
            self._blocked_workers -= 1

    def _maybe_compensate(self) -> None:
        with self._blocked_lock:
            blocked = self._blocked_workers
        runnable = any(g.deque for g in self.groups)
        if (runnable and blocked >= len(self._workers)
                and len(self._workers) < _flags.get_flag("bthread_max_concurrency")):
            self._add_worker(len(self.groups))


# ---- module-level API (the bthread_* C functions) ---------------------

def start_urgent(fn: Callable, *args, name: Optional[str] = None, **kwargs) -> int:
    """bthread_start_urgent: scheduled LIFO so it runs next."""
    return TaskControl.instance().submit(Tasklet(fn, args, kwargs, name), True)


def start_background(fn: Callable, *args, name: Optional[str] = None, **kwargs) -> int:
    """bthread_start_background: scheduled FIFO."""
    return TaskControl.instance().submit(Tasklet(fn, args, kwargs, name), False)


def in_worker() -> bool:
    return getattr(_tls, "group", None) is not None


def current_tasklet() -> Optional[Tasklet]:
    return getattr(_tls, "current", None)


def local_set(key: str, value: Any) -> None:
    """Set a bthread-local: the running tasklet's, or the calling
    thread's outside a tasklet (bthread_setspecific)."""
    cur = current_tasklet()
    if cur is not None:
        store = cur.local_storage
        if store is None:
            store = cur.local_storage = {}
    else:
        store = getattr(_tls, "fallback_store", None)
        if store is None:
            store = _tls.fallback_store = {}
    store[key] = value


def local_get(key: str, default: Any = None) -> Any:
    cur = current_tasklet()
    store = (cur.local_storage if cur is not None
             else getattr(_tls, "fallback_store", None))
    return store.get(key, default) if store else default


def note_worker_blocked() -> None:
    if in_worker():
        TaskControl.instance().note_blocked()


def note_worker_unblocked() -> None:
    if in_worker():
        TaskControl.instance().note_unblocked()
