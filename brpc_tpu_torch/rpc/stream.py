"""Streaming RPC: ordered byte/message streams attached to an RPC.

Reference: src/brpc/stream.{h,cpp} + policy/streaming_rpc_protocol.cpp,
ported from :mod:`brpc_tpu.rpc.stream`.  Semantics kept:

  * stream_create (client, stream.cpp:732) / stream_accept (server, :756):
    the stream rides the host RPC's connection; ids are exchanged through
    RpcMeta.stream_settings (the handshake, ``frame_type`` 4 on the
    request).
  * Sliding window with consumed-bytes feedback: a writer may have at most
    ``max_buf_size`` unconsumed bytes in flight (AppendIfNotFull :274);
    the receiver reports consumption watermarks (SendFeedback :572) which
    wake blocked writers (SetRemoteConsumed :307).  A DEVICE block counts
    its bytes like host bytes.
  * Delivery through a per-stream ExecutionQueue so user handlers see
    ordered batches without blocking the socket reader (Consume :526).

Frames are tpu_std RpcMeta envelopes with ``stream_settings.frame_type``:
DATA / FEEDBACK / CLOSE / RST; tpu_std routes them here from both the
server and the client parse paths, in reader order.  A DATA frame whose
IOBuf holds a device tensor crosses an ``ici://`` socket like any
attachment, on the device plane (``IciSocket._relocate``).  The transport
commits frames in the order they were written, after their copies
completed, so a FEEDBACK or CLOSE never overtakes a DATA frame whose copy
is still posted.

The out-of-band tiers (a cross-process ``FabricSocket``'s same-host shm
ring and bulk conn): a DATA frame of at least ``ici_stream_bulk_threshold``
bytes asks the socket's ``stream_fast_begin`` for a route, and the frame
carries a 16-byte ``<u64 uuid><u64 length>`` descriptor in its place:

  * ``FRAME_DATA_BULK`` (5): the descriptor first, then the bytes on the
    bulk conn, so the receiver parks in its claim while the bytes drain.
    A send that fails after its descriptor went out fails only that
    stream (its bytes are gone); the socket survives, its plane degrades,
    and later frames ride the next tier;
  * ``FRAME_DATA_SHM`` (6): the bytes first (a copy into the ring), then
    the descriptor, so a failed publish falls to the next tier for the
    same frame and costs no stream;
  * ``FRAME_DATA_SHM_BATCH`` (7): up to ``ici_stream_desc_batch``
    published ring frames announced by one control frame, flushed when the
    batch fills, before any other frame of the stream, before a writer
    parks on a full window, and after ``ici_stream_desc_flush_us``.

A stream's id pins its ring stripe, so one ring orders it.  A descriptor
for a closed stream is claimed and dropped (:func:`_discard_bulk_frame`),
returning its buffer or ring slot.  On a connection without a fast plane
such a frame fails the stream, which cannot claim its bytes.
"""
from __future__ import annotations

import struct
import time
from typing import List, Optional

from ..butil import custody_ledger as _ledger
from ..butil import debug_sync as _dbg
from ..butil import flags as _flags
from ..butil import logging as log
from ..butil.iobuf import IOBuf
from ..butil.resource_pool import ResourcePool
from ..bthread.butex import Butex
from ..bthread.execution_queue import ExecutionQueue
from . import errors

FRAME_DATA = 0
FRAME_FEEDBACK = 1
FRAME_RST = 2
FRAME_CLOSE = 3
# frame_type 4 is the tpu_std stream handshake.  5-7 are the reference's
# out-of-band DATA tiers (a 16-byte <u64 uuid><u64 length> descriptor per
# frame): the fabric bulk plane, the shm ring, and a batch of shm
# descriptors
FRAME_HANDSHAKE = 4
FRAME_DATA_BULK = 5
FRAME_DATA_SHM = 6
FRAME_DATA_SHM_BATCH = 7

_BULK_DESC = struct.Struct("<QQ")

DEFAULT_MAX_BUF_SIZE = 2 * 1024 * 1024

_flags.define_flag("ici_stream_bulk_threshold", 64 * 1024,
                   "min stream DATA frame bytes routed over the fabric "
                   "bulk plane", _flags.positive_integer)
_flags.define_flag("ici_stream_desc_batch", 32,
                   "max shm stream DATA descriptors coalesced into one "
                   "control frame", _flags.positive_integer)
_flags.define_flag("ici_stream_desc_flush_us", 1000,
                   "linger before a partial shm descriptor batch is "
                   "flushed", _flags.positive_integer)


class StreamOptions:
    def __init__(self, handler: Optional["StreamInputHandler"] = None,
                 max_buf_size: int = DEFAULT_MAX_BUF_SIZE):
        self.handler = handler
        self.max_buf_size = max_buf_size


class StreamInputHandler:
    """User callback interface (reference StreamInputHandler)."""

    def on_received_messages(self, stream_id: int,
                             messages: List[IOBuf]) -> None:
        raise NotImplementedError

    def on_idle_timeout(self, stream_id: int) -> None:
        pass

    def on_closed(self, stream_id: int) -> None:
        pass


class Stream:
    """One end of a stream.  Flow-control counters live under
    ``_flow_lock``; the connected/closed transitions and the lazy delivery
    queue under ``_state_lock``; frame sequencing and the published but
    unannounced ring frames under ``_wire_lock``, so frames leave in the
    order their sequence numbers say.
    ``close_reason`` records how the stream ended: "local" (this end
    closed it), "close" or "rst" (the peer's frame), or "socket" (the
    connection failed)."""

    _GUARDED_BY = {
        "_produced": "_flow_lock",
        "_remote_consumed": "_flow_lock",
        "_exec": "_state_lock",
        "_sock_failed_cb": "_state_lock",
        "_seq": "_wire_lock",
        "_pending_desc": "_wire_lock",
    }

    _CLOSE_MARKER = object()

    def __init__(self, options: StreamOptions, is_client: bool):
        self.options = options
        self.is_client = is_client
        self.sid: int = 0               # local id (pool id)
        self.remote_sid: int = 0        # peer's id, set at the handshake
        self.socket = None              # host connection
        self.connected = False
        self.closed = False
        self.close_reason = ""
        self._conn_butex = Butex(0)
        # sender side
        self._produced = 0
        self._remote_consumed = 0
        self._flow_lock = _dbg.make_lock("Stream._flow_lock")
        self._writable_butex = Butex(0)
        # receiver side
        self._local_consumed = 0
        self._last_feedback = 0
        self._seq = 0
        self._sock_failed_cb = None     # registered at mark_connected
        self._state_lock = _dbg.make_lock("Stream._state_lock")
        self._wire_lock = _dbg.make_lock("Stream._wire_lock")
        # ring frames published but not yet announced (frame 7), and the
        # generation that makes a stale linger timer a no-op; the timer
        # reads it without the lock (an int read; a stale positive only
        # starts a flush that finds nothing)
        self._pending_desc: List = []
        self._flush_gen = 0
        self._exec: Optional[ExecutionQueue] = None

    # -- sender ---------------------------------------------------------
    def writable_bytes(self) -> int:
        with self._flow_lock:
            return self.options.max_buf_size - (self._produced
                                                - self._remote_consumed)

    def append_if_not_full(self, data: IOBuf) -> int:
        """0 ok; EAGAIN window full; EINVAL closed (stream.cpp:274)."""
        n = len(data)
        with self._flow_lock:
            if self.closed:
                return errors.EINVAL
            if self._produced - self._remote_consumed + n \
                    > self.options.max_buf_size:
                return errors.EAGAIN
            self._produced += n
        self._send_frame(FRAME_DATA, data)
        return 0

    def write(self, data: IOBuf, timeout: Optional[float] = None) -> int:
        """Blocking write: waits for window space (StreamWrite +
        StreamWait).  0, EINVAL once closed, or ETIMEDOUT."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.append_if_not_full(data)
            if rc != errors.EAGAIN:
                return rc
            # about to park on a full window: the receiver returns credit
            # only for frames it was told of, so announce pending ones
            self._flush_pending()
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return errors.ETIMEDOUT
            self._writable_butex.wake_all_and_set(0)
            if self.writable_bytes() >= len(data) or self.closed:
                continue
            self._writable_butex.wait(0, min(remaining, 1.0)
                                      if remaining is not None else 1.0)

    def set_remote_consumed(self, consumed: int) -> None:
        """Feedback arrival: wake blocked writers (stream.cpp:307)."""
        with self._flow_lock:
            if consumed > self._remote_consumed:
                self._remote_consumed = consumed
        self._writable_butex.wake_all_and_set(1)

    # -- receiver -------------------------------------------------------
    def on_data(self, data: IOBuf) -> None:
        with self._state_lock:
            if self.closed:
                return       # raced a close: on_closed already fired
            if self._exec is None:
                # the linger keeps one consumer hot while frames stream
                # in serially, instead of a tasklet spawn per frame
                self._exec = ExecutionQueue(self._consume_batch,
                                            linger_s=0.005)
            ex = self._exec
        ex.execute(data)

    def _consume_batch(self, it) -> None:
        msgs = []
        fire_closed = False
        for m in it:
            if m is Stream._CLOSE_MARKER:
                fire_closed = True
            else:
                msgs.append(m)
        handler = self.options.handler
        consumed = sum(len(m) for m in msgs)
        if msgs and handler is not None:
            try:
                handler.on_received_messages(self.sid, msgs)
            except Exception:
                log.error("stream handler raised", exc_info=True)
        del msgs                         # the batch may hold tensors
        if consumed:
            self._local_consumed += consumed
            # feedback once half a window was consumed since the last one
            if (self._local_consumed - self._last_feedback
                    >= self.options.max_buf_size // 2 and not self.closed):
                try:
                    self.send_feedback()
                except ConnectionError:
                    pass                 # the stream is closing
        if fire_closed and handler is not None:
            try:
                handler.on_closed(self.sid)
            except Exception:
                log.error("stream on_closed raised", exc_info=True)

    def send_feedback(self) -> None:
        self._last_feedback = self._local_consumed
        self._send_frame(FRAME_FEEDBACK, None,
                         consumed_bytes=self._local_consumed)

    # -- lifecycle ------------------------------------------------------
    def wait_connected(self, timeout: float = 10.0) -> bool:
        if self.connected:
            return True
        self._conn_butex.wait(0, timeout)
        return self.connected

    def mark_connected(self, remote_sid: int, socket) -> None:
        with self._state_lock:
            if self.connected or self.closed:
                # both the response path and a racing first stream frame
                # call this; a stream closed before the handshake landed
                # registers nothing
                return
            self.remote_sid = remote_sid
            self.socket = socket
            self.connected = True
            # a dying connection closes every stream riding it; removed
            # again when the stream closes
            self._sock_failed_cb = lambda _s: self.on_remote_close("socket")
            socket.on_failed_callbacks.append(self._sock_failed_cb)
        if socket.failed:                # lost the race with set_failed
            self.on_remote_close("socket")
        self._conn_butex.wake_all_and_set(1)

    def close(self) -> None:
        """Orderly close: a CLOSE frame after every DATA frame written
        before it, then this end's handler sees on_closed after its
        queued messages."""
        with self._state_lock:
            if self.closed:
                return
            self.closed = True
            self.close_reason = "local"
        if self.connected:
            try:
                self._send_frame(FRAME_CLOSE, None)
            except ConnectionError:
                pass                     # the connection died first
        self._on_closed_local()

    def _on_closed_local(self) -> None:
        # published ring frames are still announced: the receiver claims
        # and releases them for a closed stream, returning the ring space
        self._flush_pending()
        with self._state_lock:
            cb, self._sock_failed_cb = self._sock_failed_cb, None
            sock = self.socket
        if cb is not None and sock is not None:
            try:
                sock.on_failed_callbacks.remove(cb)
            except ValueError:
                pass                     # set_failed already consumed it
        self._writable_butex.wake_all_and_set(1)
        with self._state_lock:
            # self.closed is set by every caller, so no new queue appears
            # after this read: on_data drops late frames
            ex = self._exec
        if ex is not None:
            # after every queued data batch; then the queue stops
            ex.execute(Stream._CLOSE_MARKER)
            ex.stop()
        else:
            h = self.options.handler
            if h is not None:
                try:
                    h.on_closed(self.sid)
                except Exception:
                    log.error("stream on_closed raised", exc_info=True)
        _pool_remove(self.sid)

    def on_remote_close(self, reason: str = "close") -> None:
        with self._state_lock:
            if self.closed:
                return
            self.closed = True
            self.close_reason = reason
        self._on_closed_local()

    # -- wire -----------------------------------------------------------
    def _send_frame(self, frame_type: int, data: Optional[IOBuf],
                    consumed_bytes: int = 0) -> None:
        from ..proto import rpc_meta_pb2 as meta_pb
        from ..policy.tpu_std import pack_frame
        sock = self.socket
        if sock is None:
            raise ConnectionError("stream not connected")
        payload = data if data is not None else IOBuf()
        # a large DATA frame rides a fast plane where the socket has one
        # (the route is the socket's, :mod:`..ici.route`); every other
        # socket has no stream_fast_begin and the frame stays inline
        fast_uuid, fast_route = 0, None
        fast = getattr(sock, "stream_fast_begin", None)
        if (frame_type == FRAME_DATA and fast is not None and len(payload)
                >= _flags.get_flag("ici_stream_bulk_threshold")):
            fast_uuid, fast_route = fast(len(payload), affinity=self.sid)
        meta = meta_pb.RpcMeta()
        ss = meta.stream_settings
        ss.stream_id = self.remote_sid       # addressed to receiver's id
        ss.remote_stream_id = self.sid
        if consumed_bytes:
            ss.consumed_bytes = consumed_bytes
        fast_exc = None
        rc = 0
        with self._wire_lock:
            if fast_route == "shm":
                # the bytes first: nothing names the frame until its
                # descriptor goes out, so a failed publish falls to the
                # next tier for this same frame
                try:
                    sock.stream_fast_send("shm", fast_uuid, payload)
                except Exception:
                    rc = self._flush_desc_locked(sock)
                    fast_uuid, fast_route = 0, None
                    if rc == 0:
                        fast_uuid, fast_route = fast(len(payload),
                                                     affinity=self.sid)
                    if fast_route == "shm":
                        # the ring came back between the degrade and the
                        # new route: one more try, else the next tier
                        try:
                            sock.stream_fast_send("shm", fast_uuid,
                                                  payload)
                        except Exception:
                            fast_uuid, fast_route = 0, None
            if rc == 0 and fast_route == "shm":
                self._pending_desc.append((fast_uuid, len(payload)))
                if (len(self._pending_desc)
                        >= _flags.get_flag("ici_stream_desc_batch")):
                    rc = self._flush_desc_locked(sock)
                else:
                    self._arm_flush_timer()
            elif rc == 0 and fast_uuid:
                # the bulk conn: the descriptor first (pending ring
                # descriptors before it), then the bytes
                rc = self._flush_desc_locked(sock)
                if rc == 0:
                    self._seq += 1
                    ss.frame_seq = self._seq
                    ss.frame_type = FRAME_DATA_BULK
                    rc = sock.write(pack_frame(meta, IOBuf(
                        _BULK_DESC.pack(fast_uuid, len(payload)))))
                if rc == 0:
                    try:
                        sock.stream_fast_send(fast_route, fast_uuid, payload)
                    except Exception as e:
                        # handled outside the wire lock: close() sends a
                        # CLOSE frame through here again
                        fast_exc = e
            elif rc == 0:
                # an inline frame: pending ring descriptors go first, so
                # the receiver hears of every earlier DATA frame
                rc = self._flush_desc_locked(sock)
                if rc == 0:
                    self._seq += 1
                    ss.frame_seq = self._seq
                    ss.frame_type = frame_type
                    rc = sock.write(pack_frame(meta, payload))
        if fast_exc is not None:
            # the descriptor is out and its bytes never will be: sever the
            # plane so the peer's claim fails at once (and closes its end
            # of this stream), then fail this stream
            try:
                sock.stream_fast_abort(fast_route)
            except Exception:
                pass
            self.close()
            raise ConnectionError(f"stream bulk send failed: {fast_exc}")
        if rc != 0:
            if frame_type == FRAME_DATA:
                # a refused DATA frame breaks the byte sequence: fail the
                # stream.  FEEDBACK is cumulative, so a refused one is
                # only re-reported with the next watermark
                self.close()
            raise ConnectionError(f"stream write failed: {rc}")

    # -- ring descriptor batching ----------------------------------------
    # fablint: lock-held(_wire_lock)
    def _flush_desc_locked(self, sock) -> int:
        """Announce every published, unannounced ring frame in one control
        frame (a lone one as FRAME_DATA_SHM).  The caller holds
        ``_wire_lock``; returns the write's rc (0 when nothing waited)."""
        if not self._pending_desc:
            return 0
        from ..proto import rpc_meta_pb2 as meta_pb
        from ..policy.tpu_std import pack_frame
        pending, self._pending_desc = self._pending_desc, []
        self._flush_gen += 1            # a parked linger timer is stale
        meta = meta_pb.RpcMeta()
        ss = meta.stream_settings
        ss.stream_id = self.remote_sid
        ss.remote_stream_id = self.sid
        self._seq += 1
        ss.frame_seq = self._seq
        ss.frame_type = FRAME_DATA_SHM if len(pending) == 1 \
            else FRAME_DATA_SHM_BATCH
        body = IOBuf(b"".join(_BULK_DESC.pack(u, n) for u, n in pending))
        return sock.write(pack_frame(meta, body))

    def _flush_pending(self) -> None:
        """Flush from outside the wire lock (the linger timer, a writer
        about to park).  A failed write shows at the next frame."""
        sock = self.socket
        if sock is None:
            return
        try:
            with self._wire_lock:
                self._flush_desc_locked(sock)
        except Exception:
            pass

    # fablint: lock-held(_wire_lock)
    def _arm_flush_timer(self) -> None:
        """The caller holds ``_wire_lock``: arm one linger flush per batch,
        so a writer that goes idle never strands announced-to-nobody
        frames.  The flush runs on a tasklet, never on the shared timer
        thread (a writer parked in a ring send may hold the wire lock)."""
        if len(self._pending_desc) != 1:
            return
        gen = self._flush_gen
        from ..bthread.timer_thread import TimerThread

        def fire():
            if self._flush_gen != gen:
                return
            from ..bthread import scheduler
            scheduler.start_background(self._flush_pending,
                                       name="stream_desc_flush")

        TimerThread.instance().schedule_after(
            fire, _flags.get_flag("ici_stream_desc_flush_us") / 1e6)


# ---- stream registry (versioned ids like SocketId) ---------------------

# fablint custody contract: a registry slot handed out by get_resource
# comes back through return_resource exactly once (the versioned id
# rejects doubles); _pool_remove is the single drop point every close
# path funnels through.
_CUSTODY = {"get_resource": ("return_resource",)}

_streams: ResourcePool = ResourcePool()


def _pool_remove(sid: int) -> None:
    _streams.return_resource(sid)
    _ledger.release("stream", (sid,))


def stream_create(cntl, options: Optional[StreamOptions] = None) -> Stream:
    """Client side, before issuing the host RPC (StreamCreate
    stream.cpp:732)."""
    s = Stream(options or StreamOptions(), is_client=True)
    s.sid = _streams.get_resource(s)
    _ledger.acquire("stream", (s.sid,))
    cntl.stream_creator = s
    return s


def stream_accept(cntl, options: Optional[StreamOptions] = None) -> Stream:
    """Server side, inside the handler before done() (StreamAccept
    stream.cpp:756)."""
    s = Stream(options or StreamOptions(), is_client=False)
    s.sid = _streams.get_resource(s)
    _ledger.acquire("stream", (s.sid,))
    cntl.accepted_stream_id = s.sid
    return s


def find_stream(sid: int) -> Optional[Stream]:
    return _streams.address(sid)


def live_streams() -> List[Stream]:
    """Every registered (not yet closed) stream: the server's drain gate
    filters these down to the ones riding its connections."""
    return [s for s in _streams.live_payloads() if isinstance(s, Stream)]


def on_stream_frame(meta, body: IOBuf, socket) -> None:
    """Entry from tpu_std for frames carrying stream_settings, in the
    socket's reader order, which is the stream's byte order (fast-plane
    claims too)."""
    ss = meta.stream_settings
    s = find_stream(ss.stream_id)
    if s is None:
        if ss.frame_type in (FRAME_DATA_BULK, FRAME_DATA_SHM,
                             FRAME_DATA_SHM_BATCH):
            _discard_bulk_frame(ss.frame_type, body, socket)
        return                           # stale frame for a closed stream
    if not s.connected:
        s.mark_connected(ss.remote_stream_id, socket)
    if ss.frame_type == FRAME_DATA:
        s.on_data(body)
    elif ss.frame_type == FRAME_FEEDBACK:
        s.set_remote_consumed(ss.consumed_bytes)
    elif ss.frame_type == FRAME_CLOSE:
        s.on_remote_close("close")
    elif ss.frame_type == FRAME_RST:
        s.on_remote_close("rst")
    elif ss.frame_type in (FRAME_DATA_BULK, FRAME_DATA_SHM,
                           FRAME_DATA_SHM_BATCH):
        is_shm = ss.frame_type != FRAME_DATA_BULK
        claim = getattr(socket, "stream_shm_claim" if is_shm
                        else "stream_bulk_claim", None)
        if claim is None:
            # no fast plane to claim from: dropping the frame would cut
            # the byte stream silently, so the stream fails and the
            # writer is told
            log.error("stream %d got out-of-band frame type %d on a "
                      "connection without a fast plane", s.sid,
                      ss.frame_type)
            _fail_stream(s)
            return
        raw = body.to_bytes()
        if ss.frame_type != FRAME_DATA_SHM_BATCH \
                and len(raw) != _BULK_DESC.size:
            log.error("stream %d: malformed descriptor", s.sid)
            _fail_stream(s)
            return
        for off in range(0, len(raw) - _BULK_DESC.size + 1,
                         _BULK_DESC.size):
            uuid, blen = _BULK_DESC.unpack_from(raw, off)
            try:
                data = claim(uuid, blen)
            except Exception as e:
                # the plane died under the stream: these bytes never
                # arrive, so this stream fails (the delivered prefix
                # stays).  A socket with a plane to degrade survives, its
                # plane revives and the writer is told (RST); one without
                # keeps the plane-death-is-socket-death contract
                log.error("stream %d %s frame %#x unclaimable: %s", s.sid,
                          "shm" if is_shm else "bulk", uuid, e)
                degrade = getattr(socket, "shm_plane_failed" if is_shm
                                  else "bulk_plane_failed", None)
                if degrade is not None:
                    degrade()
                    _fail_stream(s)
                else:
                    socket.set_failed(errors.EFAILEDSOCKET,
                                      f"stream bulk claim failed: {e}")
                    s.on_remote_close("rst")
                return
            s.on_data(data)


def _fail_stream(s: Stream) -> None:
    """The stream's bytes are lost: tell the writer (RST) and close."""
    try:
        s._send_frame(FRAME_RST, None)
    except ConnectionError:
        pass
    s.on_remote_close("rst")


def _discard_bulk_frame(frame_type: int, body: IOBuf, socket) -> None:
    """A fast-plane descriptor for a closed stream still has its bytes
    parked (a native buffer or a ring slot): claim and drop them, or they
    pin the receive memory until the connection dies."""
    claim = getattr(socket, "stream_bulk_claim"
                    if frame_type == FRAME_DATA_BULK
                    else "stream_shm_claim", None)
    if claim is None:
        return
    raw = body.to_bytes()
    if frame_type != FRAME_DATA_SHM_BATCH and len(raw) != _BULK_DESC.size:
        return
    for off in range(0, len(raw) - _BULK_DESC.size + 1, _BULK_DESC.size):
        uuid, blen = _BULK_DESC.unpack_from(raw, off)
        try:
            claim(uuid, blen)
        except Exception:
            pass
