"""HTTP/2 + gRPC protocol (client + server).

Reference: src/brpc/policy/http2_rpc_protocol.cpp + grpc.{h,cpp} +
details/hpack.cpp.  Self-contained implementation of the h2 framing layer
(RFC 7540: preface, SETTINGS/PING/WINDOW_UPDATE/HEADERS/DATA/RST/GOAWAY,
stream states) with HPACK (policy/hpack.py), carrying gRPC semantics
(RFC-style: 5-byte length-prefixed protobuf messages, ``:path`` =
/Service/Method, trailers with grpc-status/grpc-message).

The frames, the HPACK blocks and the gRPC messages are byte-for-byte the
JAX package's ``policy/grpc.py``, so either package's client talks to the
other's server.  Beyond it: a request whose ``grpc-timeout`` budget is
spent before the handler runs, or by the time it answers, gets
DEADLINE_EXCEEDED; and a call with ``Controller.compress_type`` set sends
its message compressed (the gRPC compressed flag with ``grpc-encoding``),
which the server answers in kind.  Streaming gRPC is not carried.

Connection state (hpack tables, live streams, ids) hangs off the socket —
the per-connection context the reference keeps in H2Context.
"""
from __future__ import annotations

import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..butil.iobuf import IOBuf
from ..rpc import compress as compress_mod
from ..rpc import errors
from ..rpc.controller import Controller
from ..rpc.protocol import Protocol, ParseResult, register_protocol
from . import hpack

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_RST_STREAM = 0x3
FRAME_SETTINGS = 0x4
FRAME_PING = 0x6
FRAME_GOAWAY = 0x7
FRAME_WINDOW_UPDATE = 0x8
FRAME_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20
FLAG_ACK = 0x1

SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384

GRPC_OK = 0
GRPC_UNKNOWN = 2
GRPC_INVALID_ARGUMENT = 3
GRPC_DEADLINE_EXCEEDED = 4
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_UNIMPLEMENTED = 12
GRPC_INTERNAL = 13
GRPC_UNAVAILABLE = 14

GRPC_UNAUTHENTICATED = 16

# bidirectional status mapping (reference grpc.cpp ErrorCodeToGrpcStatus /
# GrpcStatusToErrorCode)
_GRPC_TO_RPC = {GRPC_INVALID_ARGUMENT: errors.EREQUEST,
                GRPC_DEADLINE_EXCEEDED: errors.ERPCTIMEDOUT,
                GRPC_RESOURCE_EXHAUSTED: errors.ELIMIT,
                GRPC_UNIMPLEMENTED: errors.ENOMETHOD,
                GRPC_INTERNAL: errors.EINTERNAL,
                GRPC_UNAVAILABLE: errors.EFAILEDSOCKET,
                GRPC_UNAUTHENTICATED: errors.ERPCAUTH}
_RPC_TO_GRPC = {v: k for k, v in _GRPC_TO_RPC.items()}   # bijective

# grpc-timeout header units (gRPC HTTP/2 spec): value is ASCII digits +
# one unit char
_TIMEOUT_UNITS_NS = {b"H": 3600 * 10**9, b"M": 60 * 10**9, b"S": 10**9,
                     b"m": 10**6, b"u": 10**3, b"n": 1}


def parse_grpc_timeout_ms(value: bytes) -> Optional[int]:
    """"100m" → 100; None when absent/malformed."""
    if not value or len(value) < 2:
        return None
    unit = value[-1:]
    mult = _TIMEOUT_UNITS_NS.get(unit)
    if mult is None or not value[:-1].isdigit():
        return None
    return max(1, int(value[:-1]) * mult // 10**6)


def frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload))[1:]
            + bytes([ftype, flags]) + struct.pack(">I", stream_id & 0x7FFFFFFF)
            + payload)


def grpc_message(pb_bytes: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", len(pb_bytes)) + pb_bytes


def split_grpc_messages(data: bytes) -> List[bytes]:
    return [m for _flag, m in split_grpc_messages_flagged(data)]


def split_grpc_messages_flagged(data: bytes) -> List[Tuple[int, bytes]]:
    """``(compressed_flag, message)`` per length-prefixed message."""
    out = []
    pos = 0
    while pos + 5 <= len(data):
        flag = data[pos]
        n = struct.unpack(">I", data[pos + 1:pos + 5])[0]
        out.append((flag, data[pos + 5:pos + 5 + n]))
        pos += 5 + n
    return out


# grpc-encoding names of the compress types (rpc/compress.py)
_ENCODINGS = {compress_mod.COMPRESS_TYPE_GZIP: b"gzip",
              compress_mod.COMPRESS_TYPE_ZLIB: b"deflate"}
_ENCODING_TYPES = {v: k for k, v in _ENCODINGS.items()}


def _first_message(st: "_H2Stream") -> bytes:
    """The stream's first message, decompressed by its ``grpc-encoding``
    when its compressed flag is set.  Raises ValueError on an encoding
    this side cannot decode."""
    msgs = split_grpc_messages_flagged(bytes(st.data))
    if not msgs:
        return b""
    flag, body = msgs[0]
    if not flag:
        return body
    enc = st.header(b"grpc-encoding", b"identity")
    ctype = _ENCODING_TYPES.get(enc)
    if ctype is None:
        raise ValueError(f"unsupported grpc-encoding {enc!r}")
    return compress_mod.decompress(ctype, body)


class _H2Stream:
    __slots__ = ("stream_id", "headers", "trailers", "data", "ended",
                 "headers_done", "hdr_frag", "end_after_headers")

    def __init__(self, stream_id: int):
        self.stream_id = stream_id
        self.headers: List[Tuple[bytes, bytes]] = []
        self.trailers: List[Tuple[bytes, bytes]] = []
        self.data = bytearray()
        self.ended = False
        self.headers_done = False
        # header-block fragments accumulate here until END_HEADERS: an
        # HPACK block is one unit — decoding per-fragment corrupts any
        # string split across a CONTINUATION boundary (RFC 7540 §4.3)
        self.hdr_frag = bytearray()
        self.end_after_headers = False

    def header(self, name: bytes, default: bytes = b"") -> bytes:
        for k, v in self.headers + self.trailers:
            if k == name:
                return v
        return default


class _H2Conn:
    """Per-socket connection context (the reference's H2Context):
    hpack tables, live streams, and BOTH flow-control directions —
    the send windows here gate our DATA (RFC 7540 §5.2; reference
    http2_rpc_protocol.cpp H2Context::_remote_window_left)."""

    def __init__(self, is_server: bool):
        self.is_server = is_server
        self.preface_seen = not is_server
        self.preface_sent = False
        self.settings_sent = False
        self.enc = hpack.Encoder()
        self.dec = hpack.Decoder()
        self.streams: Dict[int, _H2Stream] = {}
        self.next_stream_id = 1          # client-initiated odd ids
        self.cid_by_stream: Dict[int, int] = {}
        # REENTRANT: with a stateful hpack encoder, header blocks must
        # hit the wire in ENCODE order — every path that encodes a block
        # holds this lock across encode AND write.  Reentrancy matters on
        # the loopback transport, where a write can deliver inline and
        # the peer's processing re-enters this side's conn.
        self.lock = threading.RLock()
        # peer-granted send windows (ours to spend)
        self.send_window = DEFAULT_WINDOW
        self.stream_send: Dict[int, int] = {}
        self.initial_window = DEFAULT_WINDOW
        self.max_frame_size = DEFAULT_MAX_FRAME
        # DATA waiting for window: stream_id -> list of [bytes, end_flag]
        self.pending: Dict[int, List] = {}
        # server: streams whose request completed but whose response
        # hasn't finished sending — the window between conn.streams pop
        # and the first response DATA, where early credit must be kept
        self.serving: set = set()
        # WINDOW_UPDATE credit granted before our first DATA on a
        # stream (a peer funding a large response upfront).  Kept OUT of
        # stream_send — booking it there would leak one entry per
        # completed call — and consumed at the
        # stream's first _send_data
        self.early_credit: Dict[int, int] = {}
        self.expect_continuation: Optional[int] = None
        self.last_processed_sid = 0      # server: for GOAWAY on stop
        # client: peer's GOAWAY last_stream_id (None = no GOAWAY seen);
        # once set, no new stream may be packed on this connection
        self.goaway_last_sid: Optional[int] = None


def _conn(socket, is_server: bool) -> _H2Conn:
    c = getattr(socket, "_h2_conn", None)
    if c is None:
        c = _H2Conn(is_server)
        socket._h2_conn = c
        if not is_server:
            # a dead h2 connection can never deliver its responses: fail
            # every outstanding stream's call (retryably) the moment the
            # socket fails, whatever killed it — GOAWAY, TCP reset,
            # server stop.  Without this, every in-flight h2 call burns
            # its full deadline on any connection death.
            cbs = getattr(socket, "on_failed_callbacks", None)
            if cbs is not None:
                cbs.append(lambda _s, conn=c: _fail_all_client_streams(conn))
    return c


def _fail_all_client_streams(conn: "_H2Conn") -> None:
    from ..bthread import id as bthread_id
    with conn.lock:
        cids = list(conn.cid_by_stream.values())
        conn.cid_by_stream.clear()
        conn.pending.clear()
    for cid in cids:
        bthread_id.error(cid, errors.EFAILEDSOCKET)


class CompletedCall:
    """A fully-received request or response stream."""

    __slots__ = ("stream", "is_request")

    def __init__(self, stream: _H2Stream, is_request: bool):
        self.stream = stream
        self.is_request = is_request


# ---- parse ------------------------------------------------------------

def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    """Consume every complete frame in order (HPACK state is sequential);
    returns the list of CompletedCalls that finished in this batch."""
    is_server = getattr(arg, "server", None) is not None
    head = source.fetch(min(len(source), len(PREFACE)))
    if head is None:
        return ParseResult.not_enough_data()
    conn = getattr(socket, "_h2_conn", None)
    if conn is None:
        if not is_server:
            return ParseResult.try_others()   # client conns init at pack time
        if len(head) < 4:
            if PREFACE.startswith(head):
                return ParseResult.not_enough_data()
            return ParseResult.try_others()
        if head[:4] != PREFACE[:4]:
            return ParseResult.try_others()
    conn = _conn(socket, is_server)
    data = source.fetch(len(source))
    pos = 0
    if is_server and not conn.preface_seen:
        if len(data) < len(PREFACE):
            return ParseResult.not_enough_data()
        if data[:len(PREFACE)] != PREFACE:
            return ParseResult.parse_error("bad h2 preface")
        conn.preface_seen = True
        pos = len(PREFACE)
        _server_send_settings(socket, conn)
    completed: List[CompletedCall] = []
    while pos + 9 <= len(data):
        length = int.from_bytes(data[pos:pos + 3], "big")
        ftype = data[pos + 3]
        flags = data[pos + 4]
        stream_id = int.from_bytes(data[pos + 5:pos + 9], "big") & 0x7FFFFFFF
        if pos + 9 + length > len(data):
            break
        payload = data[pos + 9:pos + 9 + length]
        pos += 9 + length
        _handle_frame(conn, socket, ftype, flags, stream_id, payload,
                      completed)
    source.pop_front(pos)
    if not completed:
        return ParseResult.not_enough_data()
    return ParseResult.ok(completed)


def _handle_frame(conn: _H2Conn, socket, ftype: int, flags: int,
                  stream_id: int, payload: bytes,
                  completed: List[CompletedCall]) -> None:
    # RFC 7540 §6.2: an unterminated header block admits ONLY CONTINUATION
    # frames on the same stream — ANY other frame (including control
    # frames and RST_STREAM) is a connection error, checked before every
    # early return below or the shared hpack decoder desyncs
    if conn.expect_continuation is not None and (
            ftype != FRAME_CONTINUATION
            or stream_id != conn.expect_continuation):
        _fail_h2_conn(socket,
                      "h2: frame interleaved inside a header block")
        return
    if ftype == FRAME_SETTINGS:
        if not (flags & FLAG_ACK):
            _apply_settings(conn, socket, payload)
            socket.write(IOBuf(frame(FRAME_SETTINGS, FLAG_ACK, 0, b"")))
        return
    if ftype == FRAME_PING:
        if not (flags & FLAG_ACK):
            socket.write(IOBuf(frame(FRAME_PING, FLAG_ACK, 0, payload)))
        return
    if ftype == FRAME_WINDOW_UPDATE:
        if len(payload) >= 4:
            inc = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            _on_window_update(conn, socket, stream_id, inc)
        return
    if ftype == FRAME_GOAWAY:
        if not conn.is_server:
            last_sid = (struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF) \
                if len(payload) >= 4 else 0
            _on_goaway(conn, socket, last_sid)
        return
    if ftype == FRAME_RST_STREAM:
        err = struct.unpack(">I", payload[:4])[0] if len(payload) >= 4 \
            else 0
        with conn.lock:
            conn.streams.pop(stream_id, None)
            conn.pending.pop(stream_id, None)
            _retire_stream_send(conn, stream_id)
        # a reset stream will never carry a response: complete the call
        # now instead of letting it burn its whole deadline.
        # REFUSED_STREAM (0x7) guarantees the request was NOT processed
        # (§8.1.4) → a retryable code; anything else → canceled.
        if not conn.is_server:
            _fail_client_stream(
                conn, stream_id,
                errors.EAGAIN if err == 0x7 else errors.ECANCELED)
            _close_if_drained(conn, socket)
        return
    st = conn.streams.get(stream_id)
    if st is None:
        st = _H2Stream(stream_id)
        conn.streams[stream_id] = st
    if ftype in (FRAME_HEADERS, FRAME_CONTINUATION):
        frag = payload
        if ftype == FRAME_HEADERS:
            # strip padding + priority per RFC 7540 §6.2; a pad length
            # that meets or exceeds the remaining payload is a
            # connection-level PROTOCOL_ERROR (§6.1/§6.2)
            if flags & FLAG_PADDED:
                # the 5-byte PRIORITY field also lives inside the
                # payload: pad + padlen byte + priority must all fit
                prio = 5 if flags & FLAG_PRIORITY else 0
                if not frag or frag[0] + 1 + prio > len(frag):
                    _fail_h2_conn(socket,
                                  "h2: HEADERS pad exceeds payload")
                    return
                pad = frag[0]
                frag = frag[1:len(frag) - pad]
            if flags & FLAG_PRIORITY:
                frag = frag[5:]
            st.end_after_headers = bool(flags & FLAG_END_STREAM)
        st.hdr_frag.extend(frag)
        if flags & FLAG_END_HEADERS:
            # an HPACK block decodes as ONE unit, only now that every
            # CONTINUATION fragment arrived (RFC 7540 §4.3)
            hdrs = conn.dec.decode(bytes(st.hdr_frag))
            st.hdr_frag.clear()
            conn.expect_continuation = None
            if st.headers_done:
                st.trailers.extend(hdrs)      # trailers
            else:
                st.headers.extend(hdrs)
                st.headers_done = True
        else:
            conn.expect_continuation = stream_id
        if ftype == FRAME_CONTINUATION and \
                not (flags & FLAG_END_HEADERS):
            return
        # END_STREAM on the HEADERS frame takes effect once the block
        # completes (trailers case: HEADERS+END_STREAM after DATA)
        flags = (flags & ~FLAG_END_STREAM) | (
            FLAG_END_STREAM if (st.end_after_headers
                                and not st.hdr_frag) else 0)
    elif ftype == FRAME_DATA:
        body = payload
        if flags & FLAG_PADDED:
            if not body or body[0] >= len(body):
                _fail_h2_conn(socket, "h2: DATA pad exceeds payload")
                return
            pad = body[0]
            body = body[1:len(body) - pad]
        st.data.extend(body)
        if payload:
            # auto-replenish OUR receive windows (we buffer whole
            # messages, so the window never back-pressures the peer)
            inc = struct.pack(">I", len(payload))
            socket.write(IOBuf(frame(FRAME_WINDOW_UPDATE, 0, 0, inc)
                               + frame(FRAME_WINDOW_UPDATE, 0, stream_id,
                                       inc)))
    if flags & FLAG_END_STREAM:
        st.ended = True
        conn.streams.pop(stream_id, None)
        if conn.is_server:
            # request complete, response pending: keep accepting the
            # peer's upfront response credit until the response sends
            conn.serving.add(stream_id)
        else:
            # response complete: we will never send on this stream again
            conn.early_credit.pop(stream_id, None)
        completed.append(CompletedCall(st, conn.is_server))


def _on_goaway(conn: _H2Conn, socket, last_sid: int) -> None:
    """Graceful GOAWAY (RFC 7540 §6.8).  Streams with id > last_stream_id
    were NOT processed by the peer — fail them retryably (§8.1.4) so they
    re-run on a fresh connection.  Streams ≤ last_stream_id may still get
    their responses: they keep waiting, and the socket-failure hook
    completes them if the transport actually closes.  The connection is
    logged off — no NEW stream packs onto it (pack_request refuses, the
    SocketMap replaces it on next use) — NOT set_failed: failing the whole
    conn here would discard in-flight responses the server already
    executed and auto-retry non-idempotent RPCs (reference
    http2_rpc_protocol.cpp OnGoAway/RemoveGoAwayStreams + SetLogOff)."""
    from ..bthread import id as bthread_id
    with conn.lock:
        conn.goaway_last_sid = last_sid
        refused = [(sid, cid) for sid, cid in conn.cid_by_stream.items()
                   if sid > last_sid]
        for sid, _cid in refused:
            conn.cid_by_stream.pop(sid, None)
            conn.streams.pop(sid, None)
            conn.pending.pop(sid, None)
            _retire_stream_send(conn, sid)
    socket.logoff = True
    for _sid, cid in refused:
        bthread_id.error(cid, errors.EAGAIN)
    _close_if_drained(conn, socket)


def _close_if_drained(conn: _H2Conn, socket) -> None:
    """A logged-off connection whose last awaited response has arrived
    has no further use — close it, or one orphaned fd (plus hpack state)
    accumulates per GOAWAY cycle, e.g. per rolling server deploy, on a
    long-lived client.  The peer may legally hold
    the conn open forever after GOAWAY (RFC 7540 §6.8), so WE close."""
    if getattr(socket, "logoff", False) and not conn.cid_by_stream:
        fail = getattr(socket, "set_failed", None)
        if fail is not None:
            fail(errors.EFAILEDSOCKET, "h2 GOAWAY drained")


def _fail_client_stream(conn: _H2Conn, stream_id: int, code: int) -> None:
    """Deliver a dead-stream failure through the correlation machinery
    (bthread_id.error → Controller._on_rpc_event, the discipline of
    Socket.set_failed): retryable codes actually retry, and a straggler try
    under hedging cannot destroy the live hedge's correlation id."""
    from ..bthread import id as bthread_id
    with conn.lock:
        cid = conn.cid_by_stream.pop(stream_id, None)
    if cid is None:
        return
    bthread_id.error(cid, code)


def _fail_h2_conn(socket, why: str) -> None:
    """Connection-fatal h2 condition (protocol violation or a write that
    didn't reach the wire): with a stateful hpack encoder the connection
    is unrecoverable — fail the socket so callers reconnect fresh."""
    fail = getattr(socket, "set_failed", None)
    if fail is not None:
        fail(errors.EFAILEDSOCKET, why)


def _h2_write(socket, out: IOBuf, why: str) -> int:
    """Write h2 frames; a failed write after hpack encoding desyncs the
    peer's dynamic table permanently, so the connection dies with it."""
    rc = socket.write(out)
    if rc != 0:
        _fail_h2_conn(socket, f"h2: {why} write failed ({rc}) — "
                              "hpack state unrecoverable")
    return rc


def _apply_settings(conn: _H2Conn, socket, payload: bytes) -> None:
    """Peer SETTINGS: INITIAL_WINDOW_SIZE retro-adjusts every open
    stream's send window by the delta (RFC 7540 §6.9.2)."""
    flush = False
    with conn.lock:
        for off in range(0, len(payload) - 5, 6):
            ident, value = struct.unpack_from(">HI", payload, off)
            if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                delta = value - conn.initial_window
                conn.initial_window = value
                for sid in conn.stream_send:
                    conn.stream_send[sid] += delta
                flush = delta > 0
            elif ident == SETTINGS_MAX_FRAME_SIZE:
                if 16384 <= value <= (1 << 24) - 1:
                    conn.max_frame_size = value
    if flush:
        _flush_pending(conn, socket)


def _on_window_update(conn: _H2Conn, socket, stream_id: int,
                      inc: int) -> None:
    with conn.lock:
        if stream_id == 0:
            conn.send_window += inc
        elif stream_id in conn.stream_send:
            conn.stream_send[stream_id] += inc
        elif stream_id in conn.streams or stream_id in conn.serving:
            # credit granted before our first DATA on this stream
            # (receiving the request, or serving it and not yet
            # responding): book it aside — _send_data's
            # setdefault(initial_window) would forget the grant and
            # under-credit the stream, parking DATA the peer had funded
            conn.early_credit[stream_id] = \
                conn.early_credit.get(stream_id, 0) + inc
    _flush_pending(conn, socket)


def _send_data(conn: _H2Conn, out: IOBuf, stream_id: int, data: bytes,
               end_stream: bool) -> None:
    """Emit DATA within the peer's flow-control windows (both levels,
    RFC 7540 §6.9: the lower of connection and stream window gates every
    byte), splitting at max_frame_size; what doesn't fit queues on the
    conn and drains when WINDOW_UPDATE/SETTINGS credit arrives.  Caller
    holds conn.lock."""
    if stream_id not in conn.stream_send:
        # first send on this stream: base window + any credit the peer
        # granted before we started sending
        conn.stream_send[stream_id] = conn.initial_window + \
            conn.early_credit.pop(stream_id, 0)
    if not data:
        if end_stream:                   # empty DATA costs no window
            out.append(frame(FRAME_DATA, FLAG_END_STREAM, stream_id, b""))
            _retire_stream_send(conn, stream_id)
        return
    pos = 0
    n = len(data)
    while pos < n:
        left = min(conn.send_window, conn.stream_send[stream_id],
                   conn.max_frame_size)
        if left <= 0:
            # window exhausted: park the tail (ordered per stream)
            conn.pending.setdefault(stream_id, []).append(
                [data[pos:], end_stream])
            return
        take = min(left, n - pos)
        last = (pos + take == n)
        out.append(frame(FRAME_DATA,
                         FLAG_END_STREAM if (last and end_stream) else 0,
                         stream_id, bytes(data[pos:pos + take])))
        conn.send_window -= take
        conn.stream_send[stream_id] -= take
        pos += take
    if end_stream:
        # stream fully sent: retire its window entry (a long-lived conn
        # must not accumulate one dict entry per finished stream)
        _retire_stream_send(conn, stream_id)


def _retire_stream_send(conn: _H2Conn, stream_id: int) -> None:
    """Our side of the stream is done sending: drop every per-stream
    send-side record (caller holds conn.lock)."""
    conn.stream_send.pop(stream_id, None)
    conn.early_credit.pop(stream_id, None)
    conn.serving.discard(stream_id)


def _flush_pending(conn: _H2Conn, socket) -> None:
    """Drain parked DATA now that credit returned.  Every chunk either
    emits into ``out`` or re-parks via _send_data — nothing is lost.
    The write happens UNDER conn.lock: parked trailers are hpack-encoded
    at emission time, and that block must reach the wire before any
    block encoded after it."""
    with conn.lock:
        out = IOBuf()
        parked, conn.pending = conn.pending, {}
        for sid, chunks in parked.items():
            for i, (data, end) in enumerate(chunks):
                if data is None:
                    # parked trailers ([None, header_list]): encode NOW —
                    # encoding at park time would let later blocks refer
                    # to table entries the peer hasn't seen yet
                    block = conn.enc.encode(end)
                    _append_header_block(conn, out, sid, block,
                                         end_stream=True)
                    _retire_stream_send(conn, sid)
                    continue
                _send_data(conn, out, sid, data, end)
                if sid in conn.pending:          # still blocked: keep the
                    conn.pending[sid].extend(chunks[i + 1:])   # rest, in
                    break                                      # order
        if len(out):
            _h2_write(socket, out, "flush")


def _server_send_settings(socket, conn: _H2Conn) -> None:
    if not conn.settings_sent:
        conn.settings_sent = True
        socket.write(IOBuf(frame(FRAME_SETTINGS, 0, 0, b"")))


# ---- server side ------------------------------------------------------

def process_request(calls: List[CompletedCall], socket, server) -> None:
    """Every stream completed in one read runs in a tasklet of its own
    (the first in this one): a slow handler delays only its own stream,
    as one message per tasklet does on the other protocols."""
    from ..bthread import scheduler
    for call in calls[1:]:
        scheduler.start_background(_process_one_request, call.stream,
                                   socket, server, name="h2_stream")
    if calls:
        _process_one_request(calls[0].stream, socket, server)


def send_goaway(socket) -> None:
    """Graceful-shutdown courtesy (RFC 7540 §6.8): tell the peer which
    streams were processed.  Called by Server.stop() on h2 connections
    just before failing them — best-effort: a backpressured transport
    may drop it with the rest of the write queue, and correctness does
    not depend on it (the client's socket-failure hook fails all
    outstanding calls retryably on any connection death)."""
    conn = getattr(socket, "_h2_conn", None)
    if conn is None:
        return
    payload = struct.pack(">II", conn.last_processed_sid & 0x7FFFFFFF, 0)
    socket.write(IOBuf(frame(FRAME_GOAWAY, 0, 0, payload)))


def _process_one_request(st: _H2Stream, socket, server) -> None:
    conn = getattr(socket, "_h2_conn", None)
    if conn is not None and st.stream_id > conn.last_processed_sid:
        conn.last_processed_sid = st.stream_id
    path = st.header(b":path").decode()
    parts = [p for p in path.split("/") if p]
    full_name = ".".join(parts[-2:]) if len(parts) >= 2 else path
    start_us = time.monotonic_ns() // 1000
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = socket.remote_side
    # grpc-timeout propagation (gRPC-over-HTTP/2 spec): the client's
    # deadline lands on cntl.method_deadline — the SAME server-side field
    # every other protocol uses (tpu_std), so handler code is
    # transport-independent
    deadline_ms = parse_grpc_timeout_ms(st.header(b"grpc-timeout"))
    if deadline_ms is not None:
        cntl.method_deadline = time.monotonic() + deadline_ms / 1000.0
    # one request discipline for BOTH content types on h2: switching
    # content-type bypasses neither the authenticator nor the
    # server-level overload guard
    is_grpc = st.header(b"content-type").startswith(b"application/grpc")

    def reject_early(code: int, text: str, http_code: int) -> None:
        if is_grpc:
            _send_grpc_response(socket, st.stream_id, None,
                                _RPC_TO_GRPC.get(code, GRPC_INTERNAL), text)
        else:
            import json as _json
            _send_h2_http_response(socket, st.stream_id, http_code,
                                   _json.dumps({"error": text}).encode())

    if not server.on_request_in():
        reject_early(errors.ELIMIT, "server max_concurrency reached", 503)
        return
    # counted from here on: every exit path must on_request_out
    if server.options.auth is not None:
        cntl.auth_token = st.header(b"authorization").decode(
            "utf-8", "replace")
        if not server.options.auth.verify(cntl.auth_token, socket):
            server.on_request_out()
            reject_early(errors.ERPCAUTH, "authentication failed", 401)
            return
    if not is_grpc:
        # the REST side of the reference's h2 protocol
        # (http2_rpc_protocol.cpp serves both): JSON in, JSON out, plain
        # HTTP response semantics (no grpc trailers); dispatch shared
        # with policy/http.py so the two REST planes cannot drift
        from .http import json_rpc_dispatch
        md = server.find_method(full_name)
        if md is None:
            server.on_request_out()
            import json as _json
            _send_h2_http_response(
                socket, st.stream_id, 404,
                _json.dumps({"error": f"no handler for {path}"}).encode())
            return

        def send(code: int, body_bytes: bytes) -> None:
            _send_h2_http_response(socket, st.stream_id, code, body_bytes)
            server.on_request_out()

        body = bytes(st.data).decode("utf-8", "replace") or "{}"
        json_rpc_dispatch(server, md, full_name, body, send, start_us,
                          cntl)
        return
    md = server.find_method(full_name)
    status = server.method_status(full_name) if md is not None else None

    def reply_error(code: int, text: str) -> None:
        _send_grpc_response(socket, st.stream_id, None,
                            _RPC_TO_GRPC.get(code, GRPC_INTERNAL), text)
        server.on_request_out()

    if md is None:
        reply_error(errors.ENOMETHOD, f"unknown method {path}")
        return
    if status is not None and not status.on_requested():
        status = None             # don't on_responded a rejected request
        reply_error(errors.ELIMIT,
                    f"method {full_name} max_concurrency reached")
        return
    if cntl.method_deadline is not None and \
            time.monotonic() >= cntl.method_deadline:
        # the caller's budget is spent before any work: the handler
        # never runs
        if status is not None:
            status.on_responded(errors.ERPCTIMEDOUT, 0)
        reply_error(errors.ERPCTIMEDOUT, "deadline exceeded before dispatch")
        return
    encoding = st.header(b"grpc-encoding", b"")
    resp_ctype = _ENCODING_TYPES.get(encoding, 0)
    try:
        request = md.request_cls()
        request.ParseFromString(_first_message(st))
    except Exception as e:
        if status is not None:
            status.on_responded(errors.EREQUEST, 0)
        reply_error(errors.EREQUEST, f"bad request: {e}")
        return
    response = md.response_cls()
    done_called = [False]

    def done() -> None:
        if done_called[0]:
            return
        done_called[0] = True
        if not cntl.failed() and cntl.method_deadline is not None and \
                time.monotonic() >= cntl.method_deadline:
            # answered past the caller's deadline: the caller has given
            # up, and the status says why rather than a late OK
            cntl.set_failed(errors.ERPCTIMEDOUT, "deadline exceeded")
        if cntl.failed():
            _send_grpc_response(
                socket, st.stream_id, None,
                _RPC_TO_GRPC.get(cntl.error_code_, GRPC_INTERNAL),
                cntl.error_text_)
        else:
            _send_grpc_response(socket, st.stream_id,
                                response.SerializeToString(), GRPC_OK, "",
                                compress_type=resp_ctype)
        if status is not None:
            status.on_responded(cntl.error_code_,
                                time.monotonic_ns() // 1000 - start_us)
        server.on_request_out()

    cntl.set_server_done(done)
    try:
        md.invoke(cntl, request, response, done)
    except Exception as e:
        if not done_called[0]:
            cntl.set_failed(errors.EINTERNAL, f"{type(e).__name__}: {e}")
            done()


def _send_h2_http_response(socket, stream_id: int, status_code: int,
                           body: bytes,
                           content_type: bytes = b"application/json"
                           ) -> None:
    """Plain HTTP semantics over h2 (REST responses): :status + body,
    END_STREAM on the last frame, no grpc trailers."""
    conn = socket._h2_conn
    with conn.lock:
        out = IOBuf()
        hdr = conn.enc.encode([
            (b":status", str(status_code).encode()),
            (b"content-type", content_type),
            (b"content-length", str(len(body)).encode())])
        _append_header_block(conn, out, stream_id, hdr,
                             end_stream=not body)
        if body:
            _send_data(conn, out, stream_id, body, end_stream=True)
        else:
            _retire_stream_send(conn, stream_id)
        _h2_write(socket, out, "h2 rest response")


def _append_header_block(conn: _H2Conn, out: IOBuf, stream_id: int,
                         block: bytes, end_stream: bool) -> None:
    """HEADERS (+CONTINUATIONs when the block exceeds max_frame_size,
    RFC 7540 §6.10).  Caller holds conn.lock."""
    mfs = conn.max_frame_size
    first, rest = block[:mfs], block[mfs:]
    flags = (FLAG_END_STREAM if end_stream else 0) | \
        (0 if rest else FLAG_END_HEADERS)
    out.append(frame(FRAME_HEADERS, flags, stream_id, first))
    while rest:
        frag, rest = rest[:mfs], rest[mfs:]
        out.append(frame(FRAME_CONTINUATION,
                         0 if rest else FLAG_END_HEADERS, stream_id, frag))


def _send_grpc_response(socket, stream_id: int, pb_bytes: Optional[bytes],
                        status: int, message: str,
                        compress_type: int = 0) -> None:
    conn = socket._h2_conn
    with conn.lock:
        out = IOBuf()
        head = [(b":status", b"200"),
                (b"content-type", b"application/grpc+proto")]
        if compress_type:
            head.append((b"grpc-encoding", _ENCODINGS[compress_type]))
        hdr = conn.enc.encode(head)
        _append_header_block(conn, out, stream_id, hdr, end_stream=False)
        if pb_bytes is not None:
            _send_data(conn, out, stream_id,
                       _grpc_body(pb_bytes, compress_type),
                       end_stream=False)
        trailer_list = [
            (b"grpc-status", str(status).encode()),
            (b"grpc-message", message.encode()[:512])]
        if stream_id in conn.pending:
            # DATA is parked behind the window: the trailers must follow
            # it, not jump ahead.  Park the header LIST — hpack encoding
            # happens at emission so table references stay in wire order.
            conn.pending[stream_id].append([None, trailer_list])
        else:
            _append_header_block(conn, out, stream_id,
                                 conn.enc.encode(trailer_list),
                                 end_stream=True)
            _retire_stream_send(conn, stream_id)
        _h2_write(socket, out, "response")


def _grpc_body(pb_bytes: bytes, compress_type: int) -> bytes:
    """One length-prefixed message, compressed (flag 1) when asked."""
    if not compress_type:
        return grpc_message(pb_bytes)
    data = compress_mod.compress(compress_type, pb_bytes)
    return b"\x01" + struct.pack(">I", len(data)) + data


# ---- client side ------------------------------------------------------

def serialize_request(request: Any, cntl: Controller) -> IOBuf:
    buf = IOBuf()
    if request is None:
        return buf
    if hasattr(request, "SerializeToString"):
        buf.append(request.SerializeToString())
    else:
        buf.append(bytes(request))
    return buf


def pack_request(payload: IOBuf, cid: int, cntl: Controller,
                 method_full_name: str) -> IOBuf:
    """Builds AND writes the request frames under conn.lock, returning an
    empty packet for the generic write path.  The direct write is what
    makes hpack safe under concurrency: with a stateful encoder, a block
    encoded first must reach the wire first, and a parked DATA tail must
    never be flushed (by a racing WINDOW_UPDATE) ahead of its own head."""
    sock = cntl._pack_socket
    conn = _conn(sock, is_server=False)
    service, _, method = method_full_name.rpartition(".")
    with conn.lock:
        if conn.goaway_last_sid is not None:
            # peer is going away: this conn takes no new streams.  The
            # raise maps to a retryable EFAILEDSOCKET (Controller._issue_rpc)
            # and the retry's _select_socket sees socket.logoff and
            # connects fresh.
            raise ConnectionError("h2 connection going away (GOAWAY)")
        out = IOBuf()
        if not conn.preface_sent:
            conn.preface_sent = True
            out.append(PREFACE)
            out.append(frame(FRAME_SETTINGS, 0, 0, b""))
        stream_id = conn.next_stream_id
        conn.next_stream_id += 2
        conn.cid_by_stream[stream_id] = cid
        authority = str(cntl.remote_side or "").encode() or b"fabric"
        req_headers = [
            (b":method", b"POST"),
            (b":scheme", b"http"),
            (b":path", f"/{service}/{method}".encode()),
            (b":authority", authority),
            (b"content-type", b"application/grpc+proto"),
            (b"te", b"trailers"),
        ]
        auth_token = getattr(cntl, "auth_token", "")
        if auth_token:
            req_headers.append((b"authorization",
                                auth_token if isinstance(auth_token, bytes)
                                else auth_token.encode()))
        timeout_ms = getattr(cntl, "timeout_ms", None)
        if timeout_ms and timeout_ms > 0:
            # deadline crosses the wire (gRPC spec grpc-timeout header) as
            # the REMAINING budget: a retry/hedge must not re-advertise
            # the full original timeout (the server would over-budget
            # work the client has already given up on)
            start_us = getattr(cntl, "_start_us", 0)
            if start_us:
                elapsed_ms = (time.monotonic_ns() // 1000
                              - start_us) / 1000.0
                timeout_ms = max(1, int(timeout_ms - elapsed_ms))
            req_headers.append(
                (b"grpc-timeout", b"%dm" % int(timeout_ms)))
        ctype = getattr(cntl, "compress_type", 0)
        if ctype:
            req_headers.append((b"grpc-encoding", _ENCODINGS[ctype]))
        hdr = conn.enc.encode(req_headers)
        _append_header_block(conn, out, stream_id, hdr, end_stream=False)
        _send_data(conn, out, stream_id,
                   _grpc_body(payload.to_bytes(), ctype), end_stream=True)
        rc = _h2_write(sock, out, "request")
        if rc != 0:
            raise ConnectionError(f"h2 write failed: {rc}")
    return IOBuf()


def process_response(calls: List[CompletedCall], socket) -> None:
    from ..bthread import id as bthread_id
    conn = _conn(socket, is_server=False)
    for call in calls:
        st = call.stream
        with conn.lock:
            cid = conn.cid_by_stream.pop(st.stream_id, None)
        if cid is None:
            continue
        rc, cntl = bthread_id.lock(cid)
        if rc != 0 or cntl is None:
            continue
        cntl.remote_side = socket.remote_side
        status = int(st.header(b"grpc-status", b"0") or b"0")
        if status != GRPC_OK:
            cntl.set_failed(_GRPC_TO_RPC.get(status, errors.EINTERNAL),
                            st.header(b"grpc-message").decode("utf-8",
                                                              "replace")
                            or f"grpc-status {status}")
            cntl.finish_parsed_response(cid)
            continue
        try:
            body = _first_message(st)
            if cntl._response_cls is not None:
                resp = cntl._response_cls()
                resp.ParseFromString(body)
                cntl.response = resp
            else:
                cntl.response = body
        except Exception as e:
            cntl.set_failed(errors.ERESPONSE, f"bad grpc response: {e}")
        cntl.finish_parsed_response(cid)
    _close_if_drained(conn, socket)


PROTOCOL = Protocol(
    name="grpc",
    parse=parse,
    process_request=process_request,
    process_response=process_response,
    serialize_request=serialize_request,
    pack_request=pack_request,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("grpc") is None:
        register_protocol(PROTOCOL)


_register()
