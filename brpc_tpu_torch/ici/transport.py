"""ici:// transport: RPC frames between mesh ranks, payloads in device memory.

This is the analogue of the reference's RDMA transport (src/brpc/rdma/
rdma_endpoint.cpp): where RdmaEndpoint posts zero-copy SGEs from registered
IOBuf blocks and completions arrive via CQ events, the ici transport moves
IOBuf *device blocks* between logical ranks and completions arrive via
CUDA events (bthread.device_waiter — the CQ/EventDispatcher analogue).

Wire model (one process):
  * An IciSocket connects two endpoints ``ici://a`` ↔ ``ici://b``.
  * ``write(iobuf)`` splits the buffer into the host-byte stream (protocol
    frames/meta — small) and its DEVICE block refs (bulk payload).  Host
    bytes are handed to the peer directly; a device block already owned
    by the peer's rank passes by reference; one at or above
    ``ici_device_plane_threshold`` posts on the device plane (the p2p_copy
    kernel moves it); a smaller one is copied with ``mesh.device_put``.
    The delivered IOBuf has the same layout with device refs now owned by
    the peer's rank.
  * Delivery order per socket is preserved; the payload transfer is
    awaited through its completion before the peer's input path runs —
    "read event fires when the data is in local device memory", exactly
    the RDMA completion contract.
"""
from __future__ import annotations

import collections
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from ..butil import debug_sync as _dbg
from ..butil.endpoint import EndPoint
from ..butil import flags as _flags
from ..butil.iobuf import IOBuf, IOPortal, DEVICE
from ..bthread.butex import Butex
from ..bthread.device_waiter import DeviceEventDispatcher
from ..rpc import errors
from ..rpc.socket import Socket
from . import device_plane as _dp
from .mesh import IciMesh

# Transport-level sliding window (reference: the RDMA explicit-ACK window,
# rdma_endpoint.cpp:771 CutFromIOBufList checks _window_size before posting;
# credits return piggybacked on completions).  A writer may have at most
# this many un-CONSUMED bytes at the peer; beyond it _do_write reports
# not-writable and the KeepWrite tasklet blocks until the reader drains.
_flags.define_flag("ici_socket_window_bytes", 4 * 1024 * 1024,
                   "per-ici-socket send window (unconsumed bytes at peer)",
                   _flags.positive_integer)

# the byte totals of ici:// sockets already closed.  A live socket counts
# its own (stat.out_size, device_out_size) under its write lock, so the
# write path takes no process-wide lock; its close folds them in here
# under that same lock, and a write that finishes after the fold counts
# here directly: no write is lost to a close
_ici_stats_lock = _dbg.make_lock("ici.transport._ici_stats_lock")
_retired_moved = [0, 0]


def ici_transport_stats() -> Tuple[int, int]:
    """``(bytes moved, device bytes moved)`` over every ici:// socket of
    the process (the /ici page and the default variables): the closed
    sockets' folded totals plus the live sockets' own counters."""
    from ..rpc.socket import list_sockets
    with _ici_stats_lock:
        moved, device_moved = _retired_moved
    for s in list_sockets():
        if isinstance(s, IciSocket) and not s._counters_folded:
            moved += s.stat.out_size
            device_moved += s.device_out_size
    return moved, device_moved


# device-plane transfers whose copy launched for a frame that no reader
# will parse: delivered to a socket that had failed, or left in its inbox
# when it failed.  The relocation (post_send + post_recv, one p2p_copy
# launch) runs before the delivery, and the peer may fail in between; the
# call itself fails with the peer's code and retries as before, so an
# accounting of launches against calls received adds these
_dropped_lock = threading.Lock()
_dropped_transfers = [0]


def dropped_transfers() -> int:
    """Plane transfers launched for frames a failed ici:// socket
    dropped unread (see ``IciSocket._deliver``)."""
    with _dropped_lock:
        return _dropped_transfers[0]


def _count_dropped(n: int) -> None:
    if n:
        with _dropped_lock:
            _dropped_transfers[0] += n


class CreditWindow:
    """Mixin: explicit-ACK sliding window (reference rdma_endpoint.cpp:771
    window check; credits return on consume).

    Contract for the host class (a Socket subclass): call
    ``_init_window(window_bytes)`` in __init__, gate each ``_do_write``
    through ``_consume_window(len)``, and call ``_on_credits(n)`` when the
    peer reports n consumed bytes.  A writer stalled past the
    ``_wait_writable`` timeout FAILS the socket — pending writes complete
    with an error instead of silently wedging forever."""

    _GUARDED_BY = {"_send_window": "_window_lock"}

    # fablint: init
    def _init_window(self, window_bytes: Optional[int]) -> None:
        self.window_bytes = (window_bytes if window_bytes is not None
                             else _flags.get_flag("ici_socket_window_bytes"))
        self._send_window = self.window_bytes
        self._window_lock = _dbg.make_lock("CreditWindow._window_lock")
        self._window_gen = Butex(0)       # bumped whenever credits return

    def send_window_left(self) -> int:
        with self._window_lock:
            return self._send_window

    def unacked_send_bytes(self) -> int:
        """Bytes written but not yet consumed by the peer (≤ window)."""
        with self._window_lock:
            return self.window_bytes - self._send_window

    def _consume_window(self, want: int) -> int:
        """Take up to ``want`` bytes of window; -1 when the window is
        closed (transport not writable)."""
        with self._window_lock:
            if self._send_window <= 0:
                return -1
            n = min(want, self._send_window)
            self._send_window -= n
            return n

    def _on_credits(self, n: int) -> None:
        """Peer consumed n bytes: replenish the window, wake blocked
        writers (the piggybacked-ACK path of rdma_endpoint.cpp)."""
        with self._window_lock:
            self._send_window = min(self.window_bytes, self._send_window + n)
        self._wake_window()

    def _wake_window(self) -> None:
        self._window_gen.fetch_add(1)
        self._window_gen.wake_all()

    def _peer_gone(self) -> bool:
        """Transport-specific: the far side can no longer return credits."""
        return False

    def _wait_writable(self, timeout: float = 30.0) -> bool:
        deadline = _time.monotonic() + timeout
        while not self.failed:
            gen = self._window_gen.value
            with self._window_lock:
                if self._send_window > 0:
                    return True
            if self._peer_gone():
                self.set_failed(errors.EFAILEDSOCKET,
                                "ici peer closed while window full")
                return False
            left = deadline - _time.monotonic()
            if left <= 0:
                # a stalled window must not black-hole the socket: fail it
                # so queued writes complete with an error
                self.set_failed(
                    errors.EFAILEDSOCKET,
                    f"ici send window stalled >{timeout:.0f}s "
                    f"(peer not consuming)")
                return False
            self._window_gen.wait(gen, min(left, 0.5))
        return False


class OrderedDelivery:
    """Mixin: per-socket in-order commit of received frames whose device
    payloads become ready asynchronously.  A host-only frame arriving
    after a device-bearing one must not jump the queue (byte-stream
    ordering is the transport contract the parsers rely on).

    Waits may be tensors (gated through the per-device completion poller)
    or device-plane transfers / any object exposing ``add_done_callback``
    (gated on its completion — the CQ entry)."""

    _GUARDED_BY = {"_dq": "_dq_lock", "_dq_draining": "_dq_lock"}

    # fablint: init
    def _init_delivery(self) -> None:
        self._dq = collections.deque()    # entries: [ready, commit_fn]
        self._dq_lock = _dbg.make_lock("OrderedDelivery._dq_lock")
        self._dq_draining = False

    def _enqueue_delivery(self, waits: List,
                          commit_fn: Callable[[], None]) -> None:
        entry = [False, commit_fn]
        with self._dq_lock:
            self._dq.append(entry)

        arrays = [w for w in waits if not hasattr(w, "add_done_callback")]
        handles = [w for w in waits if hasattr(w, "add_done_callback")]
        pending_arrays = bool(arrays) and not _all_ready(arrays)
        gates = len(handles) + (1 if pending_arrays else 0)
        if gates == 0:
            entry[0] = True
            self._drain_deliveries()
            return

        left = [gates]
        left_lock = threading.Lock()

        def one_gate(_err=None):
            with left_lock:
                left[0] -= 1
                if left[0] > 0:
                    return
            entry[0] = True
            self._drain_deliveries()

        if pending_arrays:
            DeviceEventDispatcher.instance().on_ready(arrays, one_gate)
        for h in handles:
            h.add_done_callback(one_gate)

    def _drain_deliveries(self) -> None:
        while True:
            with self._dq_lock:
                if (self._dq_draining or not self._dq
                        or not self._dq[0][0]):
                    return
                self._dq_draining = True
                fn = self._dq.popleft()[1]
            try:
                fn()
            finally:
                with self._dq_lock:
                    self._dq_draining = False


class IciSocket(CreditWindow, OrderedDelivery, Socket):
    # fablint guarded-state contract: the inbox and the pinned-send
    # table are touched from the writer, the reader, and the device
    # completion poller
    _GUARDED_BY = {
        "_inbox": "_inbox_lock",
        "_inflight_sends": "_inflight_lock",
        "_inflight_seq": "_inflight_lock",
    }

    def __init__(self, local_dev: int, remote_dev: int,
                 mesh: Optional[IciMesh] = None,
                 window_bytes: Optional[int] = None):
        self.mesh = mesh or IciMesh.default()
        super().__init__(remote_side=self.mesh.endpoint(remote_dev))
        self.local_dev = local_dev
        self.remote_dev = remote_dev
        # of stat.out_size, the bytes that rode DEVICE blocks
        self.device_out_size = 0
        self._counters_folded = False     # set at close, under _write_lock
        self.local_side = self.mesh.endpoint(local_dev)
        self.peer: Optional["IciSocket"] = None
        self._inbox = IOBuf()
        self._inbox_lock = _dbg.make_lock("IciSocket._inbox_lock")
        self.read_chunk_hint = 1 << 26    # _do_read cuts, never allocates
        self._peer_closed = False
        # (inbox byte offset just past a plane payload, transfers in it)
        # for frames not read yet, against the bytes appended and read so
        # far; once this socket failed its inbox is closed, and what it
        # held or is handed later counts as dropped (under _inbox_lock)
        self._inbox_marks: collections.deque = collections.deque()
        self._inbox_in = 0
        self._inbox_out = 0
        self._inbox_closed = False
        self._init_window(window_bytes)
        self._init_delivery()
        # source device blocks pinned until their copy completed
        # (reference frees _sbuf refs only on CQ completion,
        # rdma_endpoint.cpp:926 HandleCompletion)
        self._inflight_sends: Dict[int, Tuple] = {}
        self._inflight_seq = 0
        self._inflight_lock = _dbg.make_lock("IciSocket._inflight_lock")

    def inflight_send_blocks(self) -> int:
        """Device source blocks pinned awaiting copy completion."""
        with self._inflight_lock:
            return len(self._inflight_sends)

    # -- transport hooks -------------------------------------------------
    def _do_write(self, data: IOBuf) -> int:
        peer = self.peer
        if peer is None or peer.failed:
            raise ConnectionError("ici peer closed")
        n = self._consume_window(len(data))
        if n < 0:
            return -1                     # window full: not writable now
        frame = data.cut(n)
        chunks, device_n = self._relocate(frame)
        if device_n:
            with self._write_lock:
                self._count_out_locked(0, device_n)
        self._deliver(peer, chunks)
        return n

    def _count_out_locked(self, nbytes: int, device_nbytes: int) -> None:
        if self._counters_folded:
            # the socket closed while this write ran: its totals are the
            # process's now
            with _ici_stats_lock:
                _retired_moved[0] += nbytes
                _retired_moved[1] += device_nbytes
            return
        self.stat.out_size += nbytes
        self.device_out_size += device_nbytes

    def _fold_counters_locked(self) -> None:
        with _ici_stats_lock:
            _retired_moved[0] += self.stat.out_size
            _retired_moved[1] += self.device_out_size
        self._counters_folded = True

    def _relocate(self, frame: IOBuf) -> Tuple[List, int]:
        """Move DEVICE refs to the peer's rank; host refs pass through as
        bytes.  A tensor the peer's rank already owns passes by reference.
        Payloads at/above ``ici_device_plane_threshold`` post a send WR on
        the device plane — only a descriptor rides the delivery path and
        the matching recv is posted by ``_deliver`` (the QP rendezvous).
        Smaller ones are copied with ``mesh.device_put``, the counterpart
        of the JAX package's ``jax.device_put``.  Either copy lands in a
        fresh tensor, so a host buffer the caller may reuse is never
        aliased (the detach rule).  A payload the fabric delivered from
        another process and a handler forwards here is a tensor owned by
        the receiving rank like any other (the JAX package's branch for a
        host-delivered fabric view has no counterpart).  Returns the
        chunks and the bytes that rode DEVICE blocks."""
        chunks: List = []
        pending_host: List[bytes] = []
        device_n = 0
        for i in range(frame.backing_block_num()):
            r = frame.backing_block(i)
            if r.block.kind != DEVICE:
                pending_host.append(
                    bytes(r.block.host_view(r.offset, r.length)))
                continue
            if pending_host:
                chunks.append(b"".join(pending_host))
                pending_host = []
            device_n += r.length
            arr = r.block.data
            if r.offset or r.length != arr.shape[0]:
                arr = arr[r.offset:r.offset + r.length]
            src_rank = self.mesh.rank_of(arr)
            if src_rank == self.remote_dev:
                # already owned by the peer's rank: pure ref pass
                chunks.append((arr, r.length))
                continue
            if src_rank >= 0 and _dp.eligible(r.length, self.mesh, src_rank,
                                              self.remote_dev):
                t = _dp.plane().post_send(arr, src_rank, self.remote_dev,
                                          mesh=self.mesh)
                t.add_source_release(
                    getattr(r.block, "on_send_complete", None))
                chunks.append(_PlaneDesc(t, r.length))
                continue
            moved = self.mesh.device_put(arr, self.remote_dev)
            self._pin_until_sent(r.block, moved)
            chunks.append((moved, r.length))
        if pending_host:
            chunks.append(b"".join(pending_host))
        return chunks, device_n

    def _deliver(self, peer: "IciSocket", chunks: List) -> None:
        waits: List = []
        for c in chunks:
            if isinstance(c, _PlaneDesc):
                # the matching recv: rendezvous with the posted send
                c.transfer = _dp.plane().post_recv(c.transfer.uuid)
                waits.append(c.transfer)
            elif isinstance(c, tuple):
                waits.append(c[0])

        n_plane = sum(1 for c in chunks if isinstance(c, _PlaneDesc))

        def commit() -> None:
            buf = IOBuf()
            for c in chunks:
                if isinstance(c, _PlaneDesc):
                    buf.append_device_array(c.transfer.out)
                elif isinstance(c, tuple):
                    buf.append_device_array(c[0])
                else:
                    buf.append(c)
            with peer._inbox_lock:
                if peer._inbox_closed:
                    # the peer failed after this frame's relocation: its
                    # copies ran, and no reader parses the frame
                    _count_dropped(n_plane)
                    return
                peer._inbox.append(buf)
                peer._inbox_in += len(buf)
                if n_plane:
                    peer._inbox_marks.append((peer._inbox_in, n_plane))
            ok_inline = (not peer.is_server_side
                         or getattr(peer, "usercode_inline", False))
            peer.start_input_event(inline=ok_inline)

        # ordered per-socket commit: the read event fires only after the
        # payload landed at the peer's rank, and never out of arrival order
        peer._enqueue_delivery(waits, commit)

    def _pin_until_sent(self, src_block, moved) -> None:
        """Hold the SOURCE device block (and the moved tensor) until the
        copy completes; only then may the source block be reused.
        Mirrors the reference's completion-driven `_sbuf` free
        (rdma_endpoint.cpp:926): the completion source is a CUDA event,
        observed through the per-device poller."""
        with self._inflight_lock:
            seq = self._inflight_seq
            self._inflight_seq += 1
            self._inflight_sends[seq] = (src_block, moved)

        def _done(seq=seq):
            with self._inflight_lock:
                entry = self._inflight_sends.pop(seq, None)
            if entry is not None:
                cb = getattr(entry[0], "on_send_complete", None)
                if cb is not None:
                    try:
                        cb()
                    except Exception:
                        pass

        DeviceEventDispatcher.instance().on_ready([moved], _done)

    def _do_read(self, portal: IOPortal, max_count: int) -> int:
        with self._inbox_lock:
            if self._inbox_closed:
                return -1                 # failed: its inbox was dropped
            avail = len(self._inbox)
            if avail == 0:
                return 0 if self._peer_closed else -1
            n = _device_block_end(self._inbox, min(avail, max_count))
            self._inbox.cutn(portal, n)
            self._inbox_out += n
            marks = self._inbox_marks
            while marks and marks[0][0] <= self._inbox_out:
                marks.popleft()
        # consumed-bytes feedback: replenish the writer's window
        peer = self.peer
        if peer is not None and not peer.failed:
            peer._on_credits(n)
        return n

    def _peer_gone(self) -> bool:
        peer = self.peer
        return peer is None or peer.failed or self._peer_closed

    # ---- lame-duck (GOODBYE) -------------------------------------------
    def send_goodbye(self) -> None:
        """Server drain: the in-process GOODBYE — notify the peer socket
        directly (same process, no wire needed)."""
        peer = self.peer
        if peer is not None and not peer.failed:
            peer.on_peer_goodbye()

    def on_peer_goodbye(self) -> None:
        # the peer endpoint is draining: no new calls ride this socket
        # (SocketMap replaces logoff sockets on next use) and every live
        # LB pulls the endpoint now — before any health-check probe
        self.logoff = True
        from ..rpc import lameduck
        lameduck.notify_peer_draining(self.remote_side)

    def _transport_close(self) -> None:
        # once per socket (set_failed), after it left list_sockets()
        with self._inbox_lock:
            # frames not read by now are never parsed
            self._inbox_closed = True
            _count_dropped(sum(n for _, n in self._inbox_marks))
            self._inbox_marks.clear()
        peer = self.peer
        if peer is not None and not peer.failed:
            if self.failed_error == errors.ELOGOFF:
                # lame-duck hard stop: the peer's unanswered calls fail
                # with the retryable server code, on the EOF path after
                # the queued responses drain
                peer._eof_error_code = errors.ELOGOFF
            with peer._inbox_lock:
                peer._peer_closed = True
            peer.start_input_event()
            # wake the peer's blocked writers so they observe _peer_gone
            # instead of stalling out their full timeout
            peer._wake_window()
        # release our own writers blocked on the (now dead) window
        self._wake_window()


class _PlaneDesc:
    """A device-plane descriptor riding the in-process delivery path: the
    posted send's WR handle plus the payload length — the peer's
    ``post_recv`` fills in the dst-rank output at rendezvous."""

    __slots__ = ("transfer", "length")

    def __init__(self, transfer, length: int):
        self.transfer = transfer
        self.length = length


def _device_block_end(buf: IOBuf, n: int) -> int:
    """``n``, moved forward to the end of the DEVICE block it would cut:
    a read never ends inside a device block, so a received payload stays
    one view of its tensor however the reads fall."""
    if n >= len(buf):
        return n
    at = 0
    for i in range(buf.backing_block_num()):
        r = buf.backing_block(i)
        if at + r.length > n:
            return at + r.length if r.block.kind == DEVICE and at < n \
                else n
        at += r.length
    return n


def _all_ready(tensors) -> bool:
    """True when no tensor waits on a device stream (skip the poller hop):
    CPU tensors are complete when the call that made them returns."""
    return not any(t.is_cuda for t in tensors)


# ---- listener registry (ici "ports") ----------------------------------

_listeners: Dict[int, "IciListener"] = {}

# fablint guarded-state contract for the module-level registries
_GUARDED_BY_GLOBALS = {
    "_retired_moved": "_ici_stats_lock",
    "_dropped_transfers": "_dropped_lock",
    "_listeners": "_listeners_lock",
}
_listeners_lock = _dbg.make_lock("ici.transport._listeners_lock")


class IciListener:
    def __init__(self, device_id: int, on_accept, mesh: IciMesh):
        self.device_id = device_id
        self.on_accept = on_accept
        self.mesh = mesh
        # set by a server's lame-duck drain: the listener still accepts
        # (new callers get the ELOGOFF bounce) but probes read it as down
        self.draining = False

    def connect(self, client_dev: int) -> IciSocket:
        client = IciSocket(client_dev, self.device_id, self.mesh)
        serv = IciSocket(self.device_id, client_dev, self.mesh)
        client.peer, serv.peer = serv, client
        serv.is_server_side = True
        self.on_accept(serv)
        return client


def ici_listen(device_id: int, on_accept,
               mesh: Optional[IciMesh] = None) -> IciListener:
    mesh = mesh or IciMesh.default()
    with _listeners_lock:
        if device_id in _listeners:
            raise OSError(errors.EINVAL, f"ici://{device_id} already listening")
        listener = IciListener(device_id, on_accept, mesh)
        _listeners[device_id] = listener
        return listener


def ici_unlisten(device_id: int) -> None:
    with _listeners_lock:
        _listeners.pop(device_id, None)


def ici_connect(ep: EndPoint, local_dev: Optional[int] = None) -> IciSocket:
    with _listeners_lock:
        listener = _listeners.get(ep.device_id)
    if listener is None:
        raise ConnectionRefusedError(f"no server at {ep}")
    if local_dev is None:
        # default client residence: the neighbor rank (or the same rank
        # when the mesh is size 1)
        local_dev = (ep.device_id + 1) % listener.mesh.size
    return listener.connect(local_dev)
