"""Device-completion waits: the scheduler ⇄ CUDA stream bridge.

The reference's ``bthread_fd_wait`` (src/bthread/fd.cpp) runs one
EpollThread that maps fd readiness → butex wakes so bthreads block on IO
without pinning workers.  Here *device-stream completion* maps to butex
wakes: a caller enqueues work on a CUDA stream (a copy kernel, a
rank-to-rank copy), records a ``torch.cuda.Event`` on that stream, and
either blocks on or registers a callback for the event.

Design point that makes this correct without an epoll equivalent: a CUDA
stream completes its work in enqueue (FIFO) order, so ONE poller thread per
physical device, synchronizing the *oldest* outstanding event of that
device, observes every completion in order.  Events recorded on different
streams of one device may complete out of order; the poller then only
delays the later callback, never fires it early.

CPU tensors complete when the call that produced them returns, so their
callbacks run at once on the caller's thread.

At exit the pollers drain their queues and end (an ``atexit`` hook): a
daemon thread still inside ``Event.synchronize`` when the interpreter
finalizes is ended by the runtime in the middle of torch's C++ frames,
which aborts the process ("terminate called without an active
exception", SIGABRT) whatever exit code it was leaving with.
"""
from __future__ import annotations

import atexit
import collections
import threading
from typing import Callable, Deque, Dict, Optional, Sequence, Tuple

from .butex import Butex


def _complete(event, on_ready: Callable[[], None]) -> None:
    try:
        event.synchronize()      # releases the GIL while it waits
    except Exception:
        from ..butil import logging as log
        log.error("device event synchronize failed", exc_info=True)
    try:
        on_ready()
    except Exception:
        from ..butil import logging as log
        log.error("device completion callback raised", exc_info=True)


class _DevicePoller:
    def __init__(self, device_key: str):
        self.key = device_key
        self.queue: Deque[Tuple[object, Callable[[], None]]] = \
            collections.deque()
        self.cv = threading.Condition()
        self.closing = False
        # daemon: a process-lifetime poller parked on its condvar must not
        # hold the interpreter open at exit
        self.thread = threading.Thread(
            target=self._run, name=f"device_poller_{device_key}", daemon=True)
        self.thread.start()

    def submit(self, event, on_ready: Callable[[], None]) -> None:
        with self.cv:
            if not self.closing:
                self.queue.append((event, on_ready))
                self.cv.notify()
                return
        _complete(event, on_ready)   # the poller has ended: wait here

    def close(self, timeout: float) -> bool:
        """Let the poller finish what is queued, then end; True when it
        ended within ``timeout``."""
        with self.cv:
            self.closing = True
            self.cv.notify_all()
        self.thread.join(timeout)
        return not self.thread.is_alive()

    def _run(self) -> None:
        while True:
            with self.cv:
                while not self.queue:
                    if self.closing:
                        return
                    self.cv.wait()
                event, on_ready = self.queue.popleft()
            _complete(event, on_ready)
            # parked on the condvar, the loop must not keep the last
            # completion alive (its transfer holds the delivered tensor)
            event = on_ready = None


class DeviceEventDispatcher:
    """Per-device completion pollers (the EventDispatcher of the device
    plane)."""

    _instance: Optional["DeviceEventDispatcher"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._pollers: Dict[str, _DevicePoller] = {}
        self._plock = threading.Lock()

    @classmethod
    def instance(cls) -> "DeviceEventDispatcher":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DeviceEventDispatcher()
                atexit.register(cls._instance.shutdown)
            return cls._instance

    def shutdown(self, timeout: float = 10.0) -> bool:
        """Drain and end every poller (run at exit); True when all ended
        within ``timeout``.  A completion submitted afterwards runs on
        its submitter's thread."""
        with self._plock:
            pollers = list(self._pollers.values())
        ok = True
        for p in pollers:
            ok = p.close(timeout) and ok
        return ok

    def _poller_for(self, device) -> _DevicePoller:
        key = str(device)
        with self._plock:
            p = self._pollers.get(key)
            if p is None:
                p = _DevicePoller(key)
                self._pollers[key] = p
            return p

    def on_event(self, event, device, callback: Callable[[], None]) -> None:
        """Invoke callback once ``event`` (a recorded ``torch.cuda.Event``
        of ``device``) has completed."""
        self._poller_for(device).submit(event, callback)

    def on_ready(self, tensors: Sequence, callback: Callable[[], None]) -> None:
        """Invoke callback once the work that produced ``tensors`` is
        complete: an event is recorded on the current stream of their
        device, which was the producing stream.  CPU tensors are complete
        already."""
        import torch
        cuda = [t for t in tensors if t.is_cuda]
        if not cuda:
            callback()
            return
        device = cuda[0].device
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        self.on_event(ev, device, callback)


class DeviceCompletion:
    """One-shot completion record — the CQ-entry of the device plane.

    An RDMA work request completes exactly once, with a status; waiters
    either block (``wait``, butex-parked so an M:N worker yields instead
    of spinning) or register callbacks (``add_done_callback``, the
    CQ-polling analogue).  Used by ici/device_plane.py transfers."""

    __slots__ = ("_butex", "_lock", "_cbs", "_done", "error")

    def __init__(self):
        self._butex = Butex(0)
        self._lock = threading.Lock()
        self._cbs: list = []
        self._done = False
        self.error = 0

    def signal(self, error: int = 0) -> bool:
        """Complete with ``error`` (0 = success).  Exactly-once: a second
        signal is a no-op returning False.  Callbacks run on the signaling
        thread (the device poller), like CQ callbacks run on the CQ
        thread — they must not block."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            self.error = error
            cbs, self._cbs = self._cbs, []
        self._butex.wake_all_and_set(1)
        for cb in cbs:
            try:
                cb(error)
            except Exception:
                from ..butil import logging as log
                log.error("device completion callback raised", exc_info=True)
        return True

    def poll(self) -> bool:
        with self._lock:
            return self._done

    def add_done_callback(self, cb: Callable[[int], None]) -> None:
        """cb(error) once complete; fires immediately (on the caller's
        thread) when already done."""
        with self._lock:
            if not self._done:
                self._cbs.append(cb)
                return
            err = self.error
        cb(err)

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until complete.  Returns the completion's error code, or
        ETIMEDOUT (110) when the timeout expires first."""
        while True:
            with self._lock:
                if self._done:
                    return self.error
            if self._butex.wait(0, timeout) == 110:   # ETIMEDOUT
                with self._lock:
                    return self.error if self._done else 110
