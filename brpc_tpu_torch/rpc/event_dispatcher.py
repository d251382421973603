"""EventDispatcher: the readiness loop feeding TCP sockets' input events.

Port of :mod:`brpc_tpu.rpc.event_dispatcher` (reference
src/brpc/event_dispatcher*.{h,cpp}: epoll loops that tie an fd to
``Socket::StartInputEvent``, with an EPOLLOUT path that unblocks
KeepWrite).  Here a ``selectors`` loop runs on a daemon thread per
dispatcher, fds hashed across ``event_dispatcher_num`` dispatchers
(GetGlobalEventDispatcher, event_dispatcher.cpp:58-62).  Write readiness
is level-triggered and registered on demand by KeepWrite
(:meth:`add_epollout`).  The loops stop at exit (:func:`stop_all`), before
the interpreter finalizes under them.
"""
from __future__ import annotations

import atexit
import os
import selectors
import threading
from typing import Callable, Dict, List, Tuple

from ..butil import flags as _flags
from .socket import Socket

_flags.define_flag("event_dispatcher_num", 1,
                   "number of event dispatcher loops", _flags.positive_integer)


class EventDispatcher:
    def __init__(self):
        self._sel = selectors.DefaultSelector()
        # fd -> (socket id, wants EPOLLOUT)
        self._consumers: Dict[int, Tuple[int, bool]] = {}
        self._lock = threading.Lock()
        self._pending: List[Callable[[], None]] = []
        self._wakeup_r, self._wakeup_w = os.pipe()
        os.set_blocking(self._wakeup_r, False)
        os.set_blocking(self._wakeup_w, False)
        self._sel.register(self._wakeup_r, selectors.EVENT_READ, None)
        self._stop = False
        self._thread = threading.Thread(target=self._run,
                                        name="event_dispatcher", daemon=True)
        self._thread.start()

    def add_consumer(self, fd: int, socket_id: int) -> None:
        with self._lock:
            self._consumers[fd] = (socket_id, False)
        self._poke(lambda: self._register(fd, selectors.EVENT_READ))

    def add_epollout(self, fd: int, socket_id: int) -> None:
        with self._lock:
            sid, _ = self._consumers.get(fd, (socket_id, False))
            self._consumers[fd] = (sid, True)
        self._poke(lambda: self._register(
            fd, selectors.EVENT_READ | selectors.EVENT_WRITE))

    def remove_epollout(self, fd: int) -> None:
        with self._lock:
            entry = self._consumers.get(fd)
            if entry:
                self._consumers[fd] = (entry[0], False)
        self._poke(lambda: self._register(fd, selectors.EVENT_READ))

    def remove_consumer(self, fd: int) -> None:
        with self._lock:
            self._consumers.pop(fd, None)

        def _unreg():
            try:
                self._sel.unregister(fd)
            except (KeyError, ValueError, OSError):
                pass
        self._poke(_unreg)

    # -- loop internals -------------------------------------------------
    def _register(self, fd: int, events: int) -> None:
        try:
            self._sel.modify(fd, events, fd)
        except KeyError:
            try:
                self._sel.register(fd, events, fd)
            except (ValueError, OSError):
                pass
        except (ValueError, OSError):
            pass

    def _poke(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._pending.append(fn)
        try:
            os.write(self._wakeup_w, b"x")
        except (BlockingIOError, OSError):
            pass

    def _run(self) -> None:
        while not self._stop:
            try:
                events = self._sel.select(timeout=0.5)
            except (OSError, ValueError):
                events = []
            with self._lock:
                pending, self._pending = self._pending, []
            for fn in pending:
                fn()
            for key, mask in events:
                if key.fd == self._wakeup_r:
                    try:
                        os.read(self._wakeup_r, 4096)
                    except (BlockingIOError, OSError):
                        pass
                    continue
                with self._lock:
                    entry = self._consumers.get(key.fd)
                if entry is None:
                    continue
                sid, want_write = entry
                sock = Socket.address(sid)
                if sock is None:
                    self.remove_consumer(key.fd)
                    continue
                if mask & selectors.EVENT_READ:
                    sock.start_input_event()
                if mask & selectors.EVENT_WRITE and want_write:
                    self.remove_epollout(key.fd)
                    handler = getattr(sock, "handle_epollout", None)
                    if handler is not None:
                        handler()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop = True
        try:
            os.write(self._wakeup_w, b"x")
        except OSError:
            pass
        t = self._thread
        if t.is_alive() and t is not threading.current_thread():
            t.join(timeout)


_dispatchers: List[EventDispatcher] = []
_dispatchers_lock = threading.Lock()


def get_global_dispatcher(fd: int) -> EventDispatcher:
    """Hash fd -> dispatcher (event_dispatcher.cpp:58-62)."""
    with _dispatchers_lock:
        if not _dispatchers:
            for _ in range(_flags.get_flag("event_dispatcher_num")):
                _dispatchers.append(EventDispatcher())
        return _dispatchers[fd % len(_dispatchers)]


@atexit.register
def stop_all() -> None:
    """Stop and join every dispatcher loop (also the exit-time quiesce: a
    loop cut off inside a socket's input event at finalization aborts the
    process)."""
    with _dispatchers_lock:
        loops, _dispatchers[:] = list(_dispatchers), []
    for d in loops:
        d.stop()
