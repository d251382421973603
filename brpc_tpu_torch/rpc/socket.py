"""Socket: revocable connection handles with serialized, batched writes.

Reference: src/brpc/socket.{h,cpp} — the heart of the runtime.  Kept
capabilities:

  * SocketId: versioned id from a global ResourcePool (socket_id.h:35),
    returned at ``set_failed``; the pool's live ids are the socket census.
  * Write path (socket.cpp:1584-1790): callers enqueue WriteRequests; the
    first uncontended writer drains in place, leftover work moves to a
    single "KeepWrite" tasklet that batches everyone else's requests.  One
    writer at a time, writers never block each other.
  * ``set_failed`` fails pending writes and in-flight calls, and revokes
    the id (socket.cpp:863).
  * Input events are deduped by a counter so exactly one reader tasklet
    runs per socket no matter how many readiness events fire
    (StartInputEvent, socket.cpp:2046-2090).
  * An installed :class:`~.fault_injection.FaultInjector` decides each
    write ahead of the queue: a drop returns 0 and writes nothing, an
    error severs the socket.

Transport specifics live in subclasses implementing
``_do_write``/``_do_read``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ..butil.iobuf import IOBuf, IOPortal
from ..butil import flags as _flags
from ..butil.resource_pool import ResourcePool
from ..butil.endpoint import EndPoint
from ..bthread import scheduler
from . import errors
from . import fault_injection as _fi
from ..bvar.variable import PassiveStatus

_socket_pool: ResourcePool = ResourcePool()

_flags.define_flag("socket_max_unwritten_bytes", 64 * 1024 * 1024,
                   "reject writes with EOVERCROWDED beyond this backlog",
                   _flags.positive_integer)


class SocketStat:
    """Per-connection counters (reference SocketStat socket.h:123)."""

    __slots__ = ("in_size", "out_size", "in_num_messages", "out_num_messages")

    def __init__(self):
        self.in_size = 0
        self.out_size = 0
        self.in_num_messages = 0
        self.out_num_messages = 0


class WriteRequest:
    __slots__ = ("data", "notify_cid", "on_done", "completed")

    def __init__(self, data: IOBuf, notify_cid: int = 0,
                 on_done: Optional[Callable[[int], None]] = None):
        self.data = data
        self.notify_cid = notify_cid
        self.on_done = on_done      # on_done(error_code)
        self.completed = False


class Socket:
    """Base socket; see module docstring."""

    def __init__(self, remote_side: Optional[EndPoint] = None):
        self.id: int = _socket_pool.get_resource(self)
        self.remote_side = remote_side
        self.local_side: Optional[EndPoint] = None
        self.failed = False
        self.failed_error = 0
        self.failed_reason = ""
        self._write_queue: List[WriteRequest] = []
        self._unwritten = 0          # queued-but-unwritten bytes (EOVERCROWDED)
        self._write_lock = threading.Lock()
        self._writing = False
        self._nevent = 0                    # input-event dedup counter
        self._nevent_lock = threading.Lock()
        self.messenger = None               # InputMessenger set by owner
        self._read_portal = IOPortal()
        self._selected_protocol_index = -1  # protocol memory per socket
        self.stat = SocketStat()
        self.create_time = time.time()
        # the last write or input event: a server's idle reaper closes a
        # connection quiet for longer than ``idle_timeout_s``
        self.last_active = time.monotonic()
        # correlation ids written on this socket and possibly awaiting a
        # response: failed with the socket so a connection death completes
        # in-flight calls NOW instead of letting them burn their full
        # deadlines.  Completed cids linger until pruned — bthread_id's
        # version guard makes erroring a stale id a no-op.
        self._inflight_cids: set = set()
        self._inflight_prune_at = 256    # high-water mark (see write())
        self._cid_lock = threading.Lock()
        self.is_server_side = False
        # the peer announced a lame-duck drain (GOODBYE): no new call
        # rides this socket, SocketMap replaces it on next use
        self.logoff = False
        # the error a peer's close maps to once the queued input drained
        # (ELOGOFF for a server's lame-duck stop; 0 = plain EOF)
        self._eof_error_code = 0
        # called with the socket once it failed: a stream riding the
        # connection closes with it (rpc/stream.py)
        self.on_failed_callbacks: List[Callable[["Socket"], None]] = []
        # pipelined protocols (HTTP/1.1): one context per call in write
        # order; a response takes the oldest (reference socket.h
        # PipelinedInfo)
        self.pipelined_contexts: List[Any] = []
        self._pipeline_lock = threading.Lock()
        self._pipeline_write_lock = threading.Lock()

    @staticmethod
    def address(sid: int) -> Optional["Socket"]:
        """The live socket with id ``sid``, or None once it failed."""
        s = _socket_pool.address(sid)
        return s if s is not None and not s.failed else None

    def description(self) -> str:
        """One line for the /sockets page."""
        st = self.stat
        return (f"Socket{{id={self.id} remote={self.remote_side} "
                f"failed={self.failed} server_side={self.is_server_side} "
                f"in={st.in_size}B/{st.in_num_messages} "
                f"out={st.out_size}B/{st.out_num_messages}}}")

    # ---- pipelining ---------------------------------------------------
    def push_pipelined_context(self, ctx: Any) -> None:
        with self._pipeline_lock:
            self.pipelined_contexts.append(ctx)

    def pop_pipelined_context(self) -> Optional[Any]:
        with self._pipeline_lock:
            return self.pipelined_contexts.pop(0) \
                if self.pipelined_contexts else None

    # ---- failure -----------------------------------------------------
    def set_failed(self, error_code: int = errors.EFAILEDSOCKET,
                   reason: str = "") -> bool:
        with self._write_lock:
            if self.failed:
                return False
            self.failed = True
            self.failed_error = error_code
            self.failed_reason = reason
            pending = self._write_queue
            self._write_queue = []
            self._unwritten = 0
            self._fold_counters_locked()
        _socket_pool.return_resource(self.id)
        for req in pending:
            self._complete_write(req, error_code)
        for cb in list(self.on_failed_callbacks):
            try:
                cb(self)
            except Exception:
                from ..butil import logging as log
                log.error("on_failed callback raised", exc_info=True)
        # complete every call still awaiting a response on this socket:
        # its reply can never arrive now
        with self._cid_lock:
            inflight, self._inflight_cids = self._inflight_cids, set()
        if inflight:
            from ..bthread import id as bthread_id
            code = error_code or errors.EFAILEDSOCKET
            for cid in inflight:
                try:
                    bthread_id.error(cid, code)
                except Exception:
                    pass
        self._transport_close()
        return True

    # ---- write path ---------------------------------------------------
    def write(self, data: IOBuf, notify_cid: int = 0,
              on_done: Optional[Callable[[int], None]] = None) -> int:
        """Enqueue data; returns 0 or an error code immediately (completion
        is reported through on_done / correlation error)."""
        injector = _fi._active
        if injector is not None:
            action = injector.decide(self)
            if action == _fi.DROP:
                return 0                 # the bytes vanish: a lossy link
            if action == _fi.ERROR:
                self.set_failed(errors.EFAILEDSOCKET, "injected fault")
                return errors.EFAILEDSOCKET
        req = WriteRequest(data, notify_cid, on_done)
        self.last_active = time.monotonic()
        if notify_cid:
            with self._cid_lock:
                self._inflight_cids.add(notify_cid)
                if len(self._inflight_cids) > self._inflight_prune_at:
                    # prune completed calls' ids, then move the high-water
                    # mark past the LIVE population
                    from ..bthread import id as bthread_id
                    self._inflight_cids = {
                        c for c in self._inflight_cids
                        if bthread_id.is_live(c)}
                    self._inflight_prune_at = max(
                        256, 2 * len(self._inflight_cids))
        with self._write_lock:
            if self.failed:
                err = self.failed_error or errors.EFAILEDSOCKET
            elif self._unwritten > _flags.get_flag(
                    "socket_max_unwritten_bytes"):
                err = errors.EOVERCROWDED
            else:
                self._write_queue.append(req)
                self._unwritten += len(data)
                if self._writing:
                    return 0
                self._writing = True
                err = None
        if err is not None:
            self._complete_write(req, err)
            return err
        # we are the writer: write our own request in place; leftover work
        # (later writers' requests, or a transport not writable now) moves
        # to a KeepWrite tasklet that batches them
        if not self._drain(own=req):
            scheduler.start_urgent(self._keep_write, name="keep_write")
        return 0

    def _drain(self, own: Optional[WriteRequest] = None) -> bool:
        """Write head requests in order.  True: the queue emptied and the
        writer role is released.  False: the writer role stays, and the
        caller hands the rest to KeepWrite — the transport stopped
        accepting bytes, or ``own`` (an in-place writer's request) is
        written and later writers' requests remain.  An in-place writer
        writes its own request and returns (reference socket.cpp
        StartWrite): under continuous writes from other threads, draining
        them all would hold it, and its caller, until the load stopped."""
        while True:
            with self._write_lock:
                if self.failed or not self._write_queue:
                    self._writing = False
                    return True
                if own is not None and own.completed:
                    return False
                req = self._write_queue[0]
            try:
                n = self._do_write(req.data)
            except Exception as e:
                from ..butil import logging as log
                log.error("write failed on %s: %s", self.remote_side, e)
                # a transport refusal may name its own code (a device
                # payload the fabric's plane refused fails EINTERNAL)
                self.set_failed(getattr(e, "error_code",
                                        errors.EFAILEDSOCKET), str(e))
                return True
            if n < 0:           # transport not writable now
                return False
            if n > 0:
                # counted under the lock set_failed folds the counters
                # under: a write racing the close is counted once
                with self._write_lock:
                    self._unwritten = max(0, self._unwritten - n)
                    self._count_out_locked(n, 0)
            if len(req.data) == 0:
                with self._write_lock:
                    if self._write_queue and self._write_queue[0] is req:
                        self._write_queue.pop(0)
                self.stat.out_num_messages += 1
                self._complete_write(req, 0)

    def _keep_write(self) -> None:
        while True:
            if self._drain():
                return
            if not self._wait_writable():
                return

    def _complete_write(self, req: WriteRequest, error_code: int) -> None:
        with self._write_lock:
            if req.completed:
                return
            req.completed = True
        if req.on_done is not None:
            try:
                req.on_done(error_code)
            except Exception:
                pass
        if error_code != 0 and req.notify_cid:
            from ..bthread import id as bthread_id
            bthread_id.error(req.notify_cid, error_code)

    def _wait_writable(self, timeout: float = 30.0) -> bool:
        """Block until the transport can accept bytes again (EPOLLOUT
        analogue).  Default: brief yield for transports without readiness."""
        time.sleep(0.001)
        return not self.failed

    # ---- input path ---------------------------------------------------
    def start_input_event(self, inline: bool = False) -> None:
        """Readiness notification; guarantees a single reader no matter how
        many events fire.  ``inline=True`` (device transports on the
        delivering thread) runs the reader directly instead of spawning a
        tasklet — zero scheduling hops on the latency path
        (socket.cpp:2084), while the released-readership discipline in
        _process_event keeps slow handlers from blocking the connection."""
        self.last_active = time.monotonic()
        with self._nevent_lock:
            self._nevent += 1
            if self._nevent > 1:
                return
        if inline:
            self._process_event()
        else:
            scheduler.start_urgent(self._process_event, name="sock_reader")

    def _process_event(self) -> None:
        while True:
            last = None
            if self.messenger is not None:
                try:
                    last = self.messenger.on_new_messages(self)
                except Exception as e:
                    from ..butil import logging as log
                    log.error("input processing failed on %s: %s",
                              self.remote_side, e)
                    self.set_failed(errors.EFAILEDSOCKET, str(e))
            with self._nevent_lock:
                left = self._nevent - 1
                self._nevent = 1 if left > 0 else 0
                more = left > 0
            if not more:
                # readership released: the last message runs in this
                # tasklet for cache locality, but a slow handler now only
                # blocks itself — new readiness spawns a fresh reader
                if last is not None and self.messenger is not None:
                    self.messenger.process_in_place(last, self)
                return
            # more events pending: keep readership, hand the holdover to its
            # own tasklet and loop back to read
            if last is not None and self.messenger is not None:
                self.messenger._queue_message(*last, self)

    # ---- byte accounting (under _write_lock) -----------------------------
    def _count_out_locked(self, nbytes: int, device_nbytes: int) -> None:
        """Count written bytes; ``device_nbytes`` of them rode DEVICE
        blocks.  Called with ``_write_lock`` held."""
        self.stat.out_size += nbytes

    def _fold_counters_locked(self) -> None:
        """The socket is failing: a transport whose totals outlive its
        sockets folds the counters here, with ``_write_lock`` held."""

    # ---- transport hooks ----------------------------------------------
    def _do_write(self, data: IOBuf) -> int:
        raise NotImplementedError

    def _do_read(self, portal: IOPortal, max_count: int) -> int:
        """Read available bytes into portal; -1 on EAGAIN, 0 on EOF."""
        raise NotImplementedError

    def _transport_close(self) -> None:
        pass


def list_sockets() -> List[Socket]:
    """Live sockets (the census of tests and debug pages)."""
    return [s for s in _socket_pool.live_payloads()
            if isinstance(s, Socket)]


def _socket_count() -> int:
    return len(list_sockets())


# the live connections on /vars, as the reference's rpc_socket_count
_socket_count_var = PassiveStatus(_socket_count, "rpc_socket_count")
