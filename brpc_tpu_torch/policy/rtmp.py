"""RTMP — live media streaming protocol (client + server); port of
:mod:`brpc_tpu.policy.rtmp`, byte-equal on the wire.

Reference: src/brpc/rtmp.{h,cpp} (RtmpClient/RtmpClientStream/
RtmpServerStream/RtmpService API at rtmp.h:723-1130),
src/brpc/policy/rtmp_protocol.cpp (3677 L: handshake, chunk codec,
protocol-control and command dispatch), src/brpc/amf.{h,cpp} (AMF0, see
policy/amf.py).  The capability surface is the reference's: a server
hosts an RtmpService whose new_stream() returns per-stream handlers with
on_publish/on_play/on_meta_data/on_audio/on_video callbacks; a client
connects, creates streams, and publishes or plays.  Mechanism is this
framework's: the chunk/command machinery rides the existing Socket /
InputMessenger runtime (protocol-detected alongside every other wire
protocol on the same port), per-stream delivery is serialized through an
ExecutionQueue exactly like Streaming RPC, and waits use tasklet-aware
countdown events.

Wire format per Adobe's public RTMP specification: simple (non-digest)
AND digest ("complex") handshake C0C1C2/S0S1S2 — the server auto-detects
a digest-mode C1 (HMAC-SHA256 with the Genuine-FP key, schemes 0 and 1)
and answers with a digest-mode S1/S2 (rtmp_protocol.cpp's
"simple_handshake/complex handshake" split; FMS rejects H.264 publishes
from non-digest peers, which is why the complex form exists at all);
clients opt in via the ``rtmp_client_digest`` flag — chunk basic+message
headers fmt 0-3 with extended timestamps, protocol control messages 1-6,
AMF0 command/data messages, aggregate message splitting.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.iobuf import IOBuf
from ..butil import logging as log
from ..bthread.countdown import CountdownEvent
from ..bthread.execution_queue import ExecutionQueue
from ..rpc import errors
from ..butil import flags as _flags
from ..rpc.protocol import (CONNECTION_TYPE_SINGLE, ParseResult, Protocol,
                            register_protocol)
from . import amf

_flags.define_flag("rtmp_client_digest", False,
                   "RTMP clients perform the digest (complex) handshake "
                   "instead of the simple one (required by FMS for "
                   "H.264 publishes)")

# ---- message type ids (rtmp_protocol.cpp message dispatch) -------------

MSG_SET_CHUNK_SIZE = 1
MSG_ABORT = 2
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BANDWIDTH = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF3 = 15
MSG_SHARED_OBJECT_AMF3 = 16
MSG_COMMAND_AMF3 = 17
MSG_DATA_AMF0 = 18
MSG_SHARED_OBJECT_AMF0 = 19
MSG_COMMAND_AMF0 = 20
MSG_AGGREGATE = 22

# user-control event types
UC_STREAM_BEGIN = 0
UC_STREAM_EOF = 1
UC_STREAM_DRY = 2
UC_SET_BUFFER_LENGTH = 3
UC_STREAM_IS_RECORDED = 4
UC_PING_REQUEST = 6
UC_PING_RESPONSE = 7

# chunk-stream ids we originate on (any id >= 3 is an ordinary channel)
CSID_CONTROL = 2            # protocol control (spec-mandated)
CSID_COMMAND = 3            # NetConnection commands
CSID_STATUS = 5             # onStatus / stream-level commands
CSID_AUDIO = 6
CSID_VIDEO = 7
CSID_DATA = 8

HANDSHAKE_SIZE = 1536
RTMP_VERSION = 3
DEFAULT_CHUNK_SIZE = 128
OUT_CHUNK_SIZE = 4096
DEFAULT_WINDOW_ACK_SIZE = 2500000
_MAX_MESSAGE_SIZE = 64 << 20

_TIMESTAMP_MASK = 0xFFFFFF

# ---- digest ("complex") handshake -------------------------------------
# rtmp_protocol.cpp (RtmpUnsentHandshakeC/S + ComputeDigestBase): C1/S1
# embed an HMAC-SHA256 digest at an offset derived from 4 offset bytes;
# scheme 0 puts the offset field right after time+version (bytes 8-12),
# scheme 1 after the 764-byte key block (bytes 772-776).  The published
# Genuine-Adobe constants (the same tables the reference carries):

_FP_KEY = (b"Genuine Adobe Flash Player 001"
           b"\xF0\xEE\xC2\x4A\x80\x68\xBE\xE8\x2E\x00\xD0\xD1\x02\x9E"
           b"\x7E\x57\x6E\xEC\x5D\x2D\x29\x80\x6F\xAB\x93\xB8\xE6\x36"
           b"\xCF\xEB\x31\xAE")                       # 62 bytes
_FMS_KEY = (b"Genuine Adobe Flash Media Server 001"
            b"\xF0\xEE\xC2\x4A\x80\x68\xBE\xE8\x2E\x00\xD0\xD1\x02\x9E"
            b"\x7E\x57\x6E\xEC\x5D\x2D\x29\x80\x6F\xAB\x93\xB8\xE6\x36"
            b"\xCF\xEB\x31\xAE")                      # 68 bytes
_DIGEST_SIZE = 32
# digest-mode C1/S1 advertise a nonzero "version" field (flash/FMS
# version); zero means the peer speaks the simple handshake only
_C1_VERSION = b"\x80\x00\x07\x02"
_S1_VERSION = b"\x04\x05\x00\x01"


def _hmac_sha256(key: bytes, msg: bytes) -> bytes:
    import hashlib
    import hmac as _hmac
    return _hmac.new(key, msg, hashlib.sha256).digest()


def _digest_offset(block: bytes, scheme: int) -> int:
    """Digest offset within the 1536-byte block for the given scheme."""
    if scheme == 0:
        base, field = 12, block[8:12]
    else:
        base, field = 776, block[772:776]
    return base + sum(field) % 728


def _embedded_digest(block: bytes, scheme: int):
    """(digest, joined-rest) at the scheme's offset; the digest is
    valid iff HMAC(key, rest) reproduces it."""
    off = _digest_offset(block, scheme)
    digest = block[off:off + _DIGEST_SIZE]
    rest = block[:off] + block[off + _DIGEST_SIZE:]
    return digest, rest


def find_handshake_digest(block: bytes, key: bytes = _FP_KEY[:30]):
    """Locate + validate a digest-mode C1/S1.  Returns the 32-byte
    digest, or None when neither scheme validates (a simple-handshake
    peer)."""
    for scheme in (0, 1):
        digest, rest = _embedded_digest(block, scheme)
        if _hmac_sha256(key, rest) == digest:
            return digest
    return None


def make_digest_block(version: bytes, key: bytes,
                      rand: Optional[bytes] = None) -> bytes:
    """Build a digest-mode C1/S1 (scheme 0): time + version + 1528
    random bytes with the HMAC digest embedded at the derived offset.
    ``rand`` pins the randomness for fixture recording."""
    if rand is None:
        rand = os.urandom(HANDSHAKE_SIZE - 8)
    assert len(rand) == HANDSHAKE_SIZE - 8
    block = bytearray(struct.pack(">I", int(time.monotonic()) & 0xFFFFFFFF)
                      + version + rand)
    off = _digest_offset(bytes(block), 0)
    digest = _hmac_sha256(key, bytes(block[:off])
                          + bytes(block[off + _DIGEST_SIZE:]))
    block[off:off + _DIGEST_SIZE] = digest
    return bytes(block)


def make_handshake_response2(peer_digest: bytes, full_key: bytes,
                             rand: Optional[bytes] = None) -> bytes:
    """Digest-mode C2/S2: 1504 random bytes + HMAC over them, keyed with
    HMAC(full_key, peer's C1/S1 digest) — each side proves it read the
    other's digest.  S2 uses the full FMS key, C2 the full FP key."""
    if rand is None:
        rand = os.urandom(HANDSHAKE_SIZE - _DIGEST_SIZE)
    assert len(rand) == HANDSHAKE_SIZE - _DIGEST_SIZE
    key = _hmac_sha256(full_key, peer_digest)
    return rand + _hmac_sha256(key, rand)


def validate_handshake_response2(block: bytes, own_digest: bytes,
                                 full_key: bytes) -> bool:
    rand, mac = block[:-_DIGEST_SIZE], block[-_DIGEST_SIZE:]
    key = _hmac_sha256(full_key, own_digest)
    return _hmac_sha256(key, rand) == mac


class RtmpMessage:
    __slots__ = ("type", "timestamp", "msid", "body")

    def __init__(self, type: int, timestamp: int, msid: int, body: bytes):
        self.type = type
        self.timestamp = timestamp
        self.msid = msid
        self.body = body


class _InChunkState:
    """Receive-side per-csid chunk state (the reference keeps this in
    RtmpChunkStream, rtmp_protocol.cpp)."""
    __slots__ = ("timestamp", "ts_delta", "msg_len", "msg_type", "msid",
                 "has_ext_ts", "partial", "msg_remaining")

    def __init__(self):
        self.timestamp = 0
        self.ts_delta = 0
        self.msg_len = 0
        self.msg_type = 0
        self.msid = 0
        self.has_ext_ts = False
        self.partial = bytearray()
        self.msg_remaining = 0


from ..butil.misc import p24 as _p24, u24 as _u24  # noqa: E402


# ---- stream objects ----------------------------------------------------

class _RtmpStreamBase:
    """Shared stream machinery: an ExecutionQueue serializes all upcalls
    for the stream (the reference serializes through the socket's
    dispatch; we reuse the Streaming-RPC delivery pattern)."""

    def __init__(self):
        self._conn: Optional["RtmpConnection"] = None
        self.stream_id = 0                    # RTMP message stream id
        self._eq: Optional[ExecutionQueue] = None
        self._closed = False

    # -- user-overridable callbacks (rtmp.h RtmpStreamBase:723-) --------
    def on_meta_data(self, meta: Dict[str, Any], name: str = "onMetaData"
                     ) -> None:
        pass

    def on_audio_message(self, timestamp: int, data: bytes) -> None:
        pass

    def on_video_message(self, timestamp: int, data: bytes) -> None:
        pass

    def on_user_control(self, event: int, data: bytes) -> None:
        pass

    def on_stop(self) -> None:
        pass

    # -- sending --------------------------------------------------------
    def send_audio_message(self, data: bytes, timestamp: int = 0) -> int:
        return self._send_av(MSG_AUDIO, CSID_AUDIO, data, timestamp)

    def send_video_message(self, data: bytes, timestamp: int = 0) -> int:
        return self._send_av(MSG_VIDEO, CSID_VIDEO, data, timestamp)

    def send_meta_data(self, meta: Dict[str, Any],
                       name: str = "onMetaData", timestamp: int = 0) -> int:
        body = amf.encode(name, amf.EcmaArray(meta))
        return self._send_av(MSG_DATA_AMF0, CSID_DATA, body, timestamp)

    def _send_av(self, mtype: int, csid: int, data: bytes,
                 timestamp: int) -> int:
        conn = self._conn
        if conn is None or self._closed:
            return errors.EINVAL
        return conn.send_message(csid, self.stream_id, mtype, timestamp,
                                 bytes(data))

    # -- delivery (reader side) ----------------------------------------
    def _ensure_eq(self) -> ExecutionQueue:
        if self._eq is None:
            self._eq = ExecutionQueue(self._consume)
        return self._eq

    def _deliver(self, fn: Callable, *args) -> None:
        self._ensure_eq().execute((fn, args))

    def _consume(self, it) -> None:
        for fn, args in it:
            try:
                fn(*args)
            except Exception as e:
                log.error("rtmp stream callback raised: %s", e,
                          exc_info=True)

    def _shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._deliver(self.on_stop)
        if self._eq is not None:
            self._eq.stop()


class RtmpServerStream(_RtmpStreamBase):
    """Server side of one RTMP stream (rtmp.h:975-1130).  Subclass and
    override on_publish/on_play plus the base callbacks."""

    def __init__(self):
        super().__init__()
        self.publish_name = ""
        self.play_name = ""
        self.remote_side: Optional[EndPoint] = None

    def on_publish(self, name: str, publish_type: str = "live") -> int:
        """Return 0 to accept the publish, nonzero to reject."""
        return 0

    def on_play(self, name: str) -> int:
        """Return 0 to accept the play, nonzero to reject."""
        return 0

    def send_stop_message(self, description: str = "") -> int:
        """NetStream.Play.Stop to a player (rtmp.h SendStopMessage)."""
        conn = self._conn
        if conn is None:
            return errors.EINVAL
        return conn._send_status(self.stream_id, "status",
                                 "NetStream.Play.Stop",
                                 description or "Stopped.")


class RtmpService:
    """Server-side factory: one RtmpServerStream per created stream
    (rtmp.h RtmpService::NewStream).  Register via Server.add_service."""

    SERVICE_NAME = "rtmp"

    def new_stream(self, remote_side: Optional[EndPoint],
                   connect_info: Dict[str, Any]) -> RtmpServerStream:
        return RtmpServerStream()


class RtmpClientStream(_RtmpStreamBase):
    """Client side of one RTMP stream (rtmp.h:723-880): publish() or
    play() after creation; override base callbacks to receive media."""

    _TERMINAL_CODE_MARKS = ("Failed", "NotFound", "BadName", "Closed",
                            "InvalidArg", "Denied")

    def __init__(self):
        super().__init__()
        self._status_lock = threading.Lock()
        self._status_queue: List[Dict[str, Any]] = []
        self._status_event = CountdownEvent(1)
        self._status_code = ""
        self._status_info: Dict[str, Any] = {}

    # reader side: onStatus routed here
    def _on_status(self, info: Dict[str, Any]) -> None:
        with self._status_lock:
            self._status_queue.append(info)
            self._status_event.signal()
        self._deliver(self.on_status, info)

    def on_status(self, info: Dict[str, Any]) -> None:
        pass

    def _wait_status(self, want: str, timeout: float) -> int:
        """Wait for a terminal status: the wanted code succeeds, an
        error-level or *.Failed/NotFound/... code fails; informational
        codes in between (NetStream.Play.Reset) are consumed and waiting
        continues."""
        deadline = time.monotonic() + timeout
        while True:
            with self._status_lock:
                while self._status_queue:
                    info = self._status_queue.pop(0)
                    code = str(info.get("code", ""))
                    self._status_code = code
                    self._status_info = info
                    if want in code:
                        return 0
                    if info.get("level") == "error" or any(
                            m in code for m in self._TERMINAL_CODE_MARKS):
                        return errors.EREQUEST
                self._status_event.reset(1)
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._status_event.wait(remaining) != 0:
                return errors.ERPCTIMEDOUT

    def publish(self, name: str, publish_type: str = "live",
                timeout: float = 5.0) -> int:
        conn, err = self._require_conn()
        if err:
            return err
        body = amf.encode("publish", 0.0, None, name, publish_type)
        conn.send_message(CSID_STATUS, self.stream_id, MSG_COMMAND_AMF0, 0,
                          body)
        return self._wait_status("Publish.Start", timeout)

    def play(self, name: str, start: float = -2.0,
             timeout: float = 5.0) -> int:
        conn, err = self._require_conn()
        if err:
            return err
        body = amf.encode("play", 0.0, None, name, start)
        conn.send_message(CSID_STATUS, self.stream_id, MSG_COMMAND_AMF0, 0,
                          body)
        return self._wait_status("Play.Start", timeout)

    def close(self) -> None:
        conn = self._conn
        if conn is not None and not self._closed:
            body = amf.encode("deleteStream", 0.0, None,
                              float(self.stream_id))
            conn.send_message(CSID_COMMAND, 0, MSG_COMMAND_AMF0, 0, body)
            conn._drop_stream(self.stream_id)
        self._shutdown()

    def _require_conn(self):
        if self._conn is None or self._closed:
            return None, errors.EINVAL
        return self._conn, 0


# ---- the connection state machine --------------------------------------

_HS_WAIT_C0C1 = 0           # server: waiting for C0+C1
_HS_WAIT_C2 = 1             # server: waiting for C2
_HS_WAIT_S0S1S2 = 2         # client: waiting for S0+S1+S2
_ESTABLISHED = 3


class RtmpConnection:
    """Per-socket RTMP state: handshake progress, chunk codec state both
    directions, message-stream registry, pending transactions.  Attached
    as socket._rtmp_conn (the pattern h2 uses for its connection state)."""

    def __init__(self, socket, is_server: bool, server=None):
        self.socket = socket
        self.is_server = is_server
        self.server = server
        self.state = _HS_WAIT_C0C1 if is_server else _HS_WAIT_S0S1S2
        self.in_chunk_size = DEFAULT_CHUNK_SIZE
        self.out_chunk_size = DEFAULT_CHUNK_SIZE
        self.ack_window = DEFAULT_WINDOW_ACK_SIZE   # peer-announced
        self.in_bytes_total = 0
        self.in_bytes_unacked = 0
        self.connect_info: Dict[str, Any] = {}
        self.connected = CountdownEvent(1)          # client: connect done
        self.connect_error = 0
        self._in_streams: Dict[int, _InChunkState] = {}
        self._streams: Dict[int, _RtmpStreamBase] = {}
        self._streams_lock = threading.Lock()
        self._next_msid = 1
        self._next_txn = 2                          # 1 was "connect"
        self._pending: Dict[int, tuple] = {}        # txn -> (event, box)
        self._pending_lock = threading.Lock()
        self._out_lock = threading.RLock()
        self._c1_sent = b""
        self._c1_digest: Optional[bytes] = None
        self._connect_request: Dict[str, Any] = {}
        socket.on_failed_callbacks.append(self._on_socket_failed)

    # ---- outbound ------------------------------------------------------

    def _start_client_handshake(self) -> None:
        if _flags.get_flag("rtmp_client_digest"):
            c1 = make_digest_block(_C1_VERSION, _FP_KEY[:30])
            self._c1_digest = find_handshake_digest(c1)
        else:
            c1 = struct.pack(">II", int(time.monotonic()) & 0xFFFFFFFF, 0) \
                + os.urandom(HANDSHAKE_SIZE - 8)
            self._c1_digest = None
        self._c1_sent = c1
        self.socket.write(IOBuf(bytes([RTMP_VERSION]) + c1))

    def send_message(self, csid: int, msid: int, mtype: int,
                     timestamp: int, body: bytes) -> int:
        """Chunk one message onto the wire: fmt-0 header + fmt-3
        continuations (always-absolute timestamps keep the sender simple;
        receivers must support all fmts regardless)."""
        ts = timestamp & 0xFFFFFFFF
        ext = ts >= _TIMESTAMP_MASK
        hdr_ts = _TIMESTAMP_MASK if ext else ts
        out = bytearray()
        out += self._basic_header(0, csid)
        out += _p24(hdr_ts) + _p24(len(body)) + bytes([mtype]) \
            + struct.pack("<I", msid)
        if ext:
            out += struct.pack(">I", ts)
        off = 0
        n = len(body)
        with self._out_lock:                 # message-atomic chunking
            chunk = self.out_chunk_size
            take = min(chunk, n - off)
            out += body[off:off + take]
            off += take
            while off < n:
                out += self._basic_header(3, csid)
                if ext:
                    out += struct.pack(">I", ts)
                take = min(chunk, n - off)
                out += body[off:off + take]
                off += take
            return self.socket.write(IOBuf(bytes(out)))

    @staticmethod
    def _basic_header(fmt: int, csid: int) -> bytes:
        if csid < 64:
            return bytes([(fmt << 6) | csid])
        if csid < 320:
            return bytes([(fmt << 6), csid - 64])
        return bytes([(fmt << 6) | 1]) + struct.pack("<H", csid - 64)

    def _send_control(self, mtype: int, body: bytes) -> None:
        self.send_message(CSID_CONTROL, 0, mtype, 0, body)

    def _send_command(self, csid: int, msid: int, *vals: Any) -> None:
        self.send_message(csid, msid, MSG_COMMAND_AMF0, 0,
                          amf.encode(*vals))

    def _send_status(self, msid: int, level: str, code: str,
                     description: str) -> int:
        info = {"level": level, "code": code, "description": description}
        return self.send_message(CSID_STATUS, msid, MSG_COMMAND_AMF0, 0,
                                 amf.encode("onStatus", 0.0, None, info))

    def set_out_chunk_size(self, size: int) -> None:
        # announce + apply atomically w.r.t. concurrent senders (the lock
        # is reentrant: send_message chunks under it too), so no message
        # can be chunked with the old size after the peer switched
        with self._out_lock:
            self._send_control(MSG_SET_CHUNK_SIZE, struct.pack(">I", size))
            self.out_chunk_size = size

    # ---- client transactions ------------------------------------------

    def call_command(self, name: str, *args: Any, timeout: float = 5.0):
        """Send a transaction-numbered NetConnection command and wait for
        its _result (client side)."""
        with self._pending_lock:
            txn = self._next_txn
            self._next_txn += 1
            ev = CountdownEvent(1)
            box: List[Any] = []
            self._pending[txn] = (ev, box)
        self._send_command(CSID_COMMAND, 0, name, float(txn), *args)
        if ev.wait(timeout) != 0:
            with self._pending_lock:
                self._pending.pop(txn, None)
            return None, errors.ERPCTIMEDOUT
        if not box or box[0] == "_error":
            return None, errors.EREQUEST
        return box[1:], 0

    # ---- inbound -------------------------------------------------------

    def consume(self, source: IOBuf) -> bool:
        """Drain everything processable from the read buffer; returns
        False on a protocol error (connection must die)."""
        try:
            while True:
                before = len(source)
                if self.state != _ESTABLISHED:
                    if not self._consume_handshake(source):
                        return True if not self.socket.failed else False
                else:
                    if not self._consume_chunk(source):
                        return True
                consumed = before - len(source)
                self.in_bytes_total += consumed
                self.in_bytes_unacked += consumed
                if self.in_bytes_unacked >= self.ack_window:
                    self._send_control(
                        MSG_ACK, struct.pack(
                            ">I", self.in_bytes_total & 0xFFFFFFFF))
                    self.in_bytes_unacked = 0
                if consumed == 0:
                    return True
        except (amf.AmfError, struct.error, ValueError) as e:
            log.error("rtmp protocol error: %s", e)
            return False

    def _consume_handshake(self, source: IOBuf) -> bool:
        if self.state == _HS_WAIT_C0C1:
            data = source.fetch(1 + HANDSHAKE_SIZE)
            if data is None:
                return False
            if data[0] != RTMP_VERSION:
                raise ValueError(f"bad RTMP version {data[0]}")
            source.pop_front(1 + HANDSHAKE_SIZE)
            c1 = data[1:]
            # digest auto-detection (rtmp_protocol.cpp: try the complex
            # handshake, fall back to simple): a C1 whose HMAC validates
            # under either scheme gets a digest-mode S1 + keyed S2; a
            # plain C1 gets the simple echo
            c1_digest = find_handshake_digest(c1)
            if c1_digest is not None:
                s1 = make_digest_block(_S1_VERSION, _FMS_KEY[:36])
                s2 = make_handshake_response2(c1_digest, _FMS_KEY)
            else:
                s1 = struct.pack(">II", 0, 0) \
                    + os.urandom(HANDSHAKE_SIZE - 8)
                s2 = c1
            self.socket.write(IOBuf(bytes([RTMP_VERSION]) + s1 + s2))
            self.state = _HS_WAIT_C2
            return True
        if self.state == _HS_WAIT_C2:
            if source.fetch(HANDSHAKE_SIZE) is None:
                return False
            source.pop_front(HANDSHAKE_SIZE)
            self.state = _ESTABLISHED
            return True
        if self.state == _HS_WAIT_S0S1S2:
            data = source.fetch(1 + 2 * HANDSHAKE_SIZE)
            if data is None:
                return False
            if data[0] != RTMP_VERSION:
                raise ValueError(f"bad RTMP version {data[0]}")
            source.pop_front(1 + 2 * HANDSHAKE_SIZE)
            s1 = data[1:1 + HANDSHAKE_SIZE]
            s2 = data[1 + HANDSHAKE_SIZE:]
            c2 = s1                             # simple: C2 echoes S1
            if self._c1_digest is not None:
                # digest mode: validate the server's proof-of-read,
                # then key C2 on ITS digest.  A simple-handshake server
                # (no valid S1 digest) downgrades us gracefully — the
                # reference proceeds the same way
                s1_digest = find_handshake_digest(s1, _FMS_KEY[:36])
                if s1_digest is not None:
                    if not validate_handshake_response2(
                            s2, self._c1_digest, _FMS_KEY):
                        raise ValueError("rtmp digest handshake: S2 "
                                         "proof-of-read invalid")
                    c2 = make_handshake_response2(s1_digest, _FP_KEY)
                else:
                    log.warning("rtmp: digest C1 answered by a "
                                "simple-handshake server; downgrading")
            self.socket.write(IOBuf(c2))
            self.state = _ESTABLISHED
            self._on_client_established()
            return True
        return False

    def _consume_chunk(self, source: IOBuf) -> bool:
        """Parse exactly one chunk if fully buffered (returns False to
        wait for more bytes)."""
        b0 = source.fetch(1)
        if b0 is None:
            return False
        fmt = b0[0] >> 6
        csid = b0[0] & 0x3F
        bh_len = 1
        if csid == 0:
            hdr = source.fetch(2)
            if hdr is None:
                return False
            csid = 64 + hdr[1]
            bh_len = 2
        elif csid == 1:
            hdr = source.fetch(3)
            if hdr is None:
                return False
            csid = 64 + hdr[1] + (hdr[2] << 8)
            bh_len = 3
        cs = self._in_streams.get(csid)
        if cs is None:
            cs = self._in_streams[csid] = _InChunkState()
        mh_len = (11, 7, 3, 0)[fmt]
        head = source.fetch(bh_len + mh_len)
        if head is None:
            return False
        mh = head[bh_len:]
        # provisional header decode to learn ext-ts presence
        ext = cs.has_ext_ts if fmt == 3 else (_u24(mh) >= _TIMESTAMP_MASK)
        ext_len = 4 if ext else 0
        new_message = cs.msg_remaining == 0
        if new_message:
            if fmt == 0:
                msg_len = _u24(mh, 3)
            elif fmt in (1, 2):
                msg_len = _u24(mh, 3) if fmt == 1 else cs.msg_len
            else:
                msg_len = cs.msg_len
            take = min(self.in_chunk_size, msg_len)
        else:
            if fmt != 3:
                raise ValueError(
                    f"chunk fmt {fmt} inside a partial message (csid "
                    f"{csid})")
            take = min(self.in_chunk_size, cs.msg_remaining)
        total = bh_len + mh_len + ext_len + take
        data = source.fetch(total)
        if data is None:
            return False
        source.pop_front(total)
        if ext:
            ts_field = struct.unpack_from(">I", data, bh_len + mh_len)[0]
        elif fmt != 3:
            ts_field = _u24(mh)
        else:
            ts_field = 0                    # fmt3 carries no timestamp
        if new_message:
            if fmt == 0:
                cs.timestamp = ts_field
                cs.ts_delta = 0
                cs.msg_len = _u24(mh, 3)
                cs.msg_type = mh[6]
                cs.msid = struct.unpack_from("<I", mh, 7)[0]
            elif fmt == 1:
                cs.ts_delta = ts_field
                cs.timestamp = (cs.timestamp + ts_field) & 0xFFFFFFFF
                cs.msg_len = _u24(mh, 3)
                cs.msg_type = mh[6]
            elif fmt == 2:
                cs.ts_delta = ts_field
                cs.timestamp = (cs.timestamp + ts_field) & 0xFFFFFFFF
            else:
                cs.timestamp = (cs.timestamp + cs.ts_delta) & 0xFFFFFFFF
            cs.has_ext_ts = ext
            if cs.msg_len > _MAX_MESSAGE_SIZE:
                raise ValueError(f"rtmp message too large: {cs.msg_len}")
            cs.msg_remaining = cs.msg_len
            cs.partial = bytearray()
        payload = data[bh_len + mh_len + ext_len:]
        cs.partial += payload
        cs.msg_remaining -= len(payload)
        if cs.msg_remaining == 0 and (cs.msg_len == 0 or cs.partial):
            msg = RtmpMessage(cs.msg_type, cs.timestamp, cs.msid,
                              bytes(cs.partial))
            cs.partial = bytearray()
            self._dispatch(msg)
        return True

    # ---- message dispatch ---------------------------------------------

    def _dispatch(self, msg: RtmpMessage) -> None:
        t = msg.type
        if t == MSG_SET_CHUNK_SIZE:
            if len(msg.body) >= 4:
                self.in_chunk_size = max(
                    1, struct.unpack(">I", msg.body[:4])[0] & 0x7FFFFFFF)
        elif t == MSG_ABORT:
            if len(msg.body) >= 4:
                csid = struct.unpack(">I", msg.body[:4])[0]
                cs = self._in_streams.get(csid)
                if cs is not None:
                    cs.partial = bytearray()
                    cs.msg_remaining = 0
        elif t == MSG_ACK:
            pass
        elif t == MSG_WINDOW_ACK_SIZE:
            if len(msg.body) >= 4:
                self.ack_window = max(
                    1, struct.unpack(">I", msg.body[:4])[0])
        elif t == MSG_SET_PEER_BANDWIDTH:
            pass
        elif t == MSG_USER_CONTROL:
            self._on_user_control(msg)
        elif t in (MSG_COMMAND_AMF0, MSG_COMMAND_AMF3):
            body = msg.body
            if t == MSG_COMMAND_AMF3 and body[:1] == b"\x00":
                body = body[1:]          # AMF3 envelope: format selector
            vals = amf.decode_all(body)
            if vals:
                self._on_command(msg, vals)
        elif t in (MSG_DATA_AMF0, MSG_DATA_AMF3):
            body = msg.body
            if t == MSG_DATA_AMF3 and body[:1] == b"\x00":
                body = body[1:]
            self._on_data(msg, amf.decode_all(body))
        elif t == MSG_AUDIO:
            s = self._streams.get(msg.msid)
            if s is not None:
                s._deliver(s.on_audio_message, msg.timestamp, msg.body)
        elif t == MSG_VIDEO:
            s = self._streams.get(msg.msid)
            if s is not None:
                s._deliver(s.on_video_message, msg.timestamp, msg.body)
        elif t == MSG_AGGREGATE:
            self._split_aggregate(msg)

    def _on_user_control(self, msg: RtmpMessage) -> None:
        if len(msg.body) < 2:
            return
        ev = struct.unpack(">H", msg.body[:2])[0]
        data = msg.body[2:]
        if ev == UC_PING_REQUEST:
            self._send_control(MSG_USER_CONTROL,
                               struct.pack(">H", UC_PING_RESPONSE) + data)
            return
        if len(data) >= 4:
            msid = struct.unpack(">I", data[:4])[0]
            s = self._streams.get(msid)
            if s is not None:
                s._deliver(s.on_user_control, ev, data)

    def _split_aggregate(self, msg: RtmpMessage) -> None:
        """Aggregate body = FLV-style tags (type,size,ts,msid) each
        followed by a 4-byte back-pointer (rtmp_protocol.cpp aggregate
        handling)."""
        body = msg.body
        off = 0
        base_ts: Optional[int] = None
        while off + 11 <= len(body):
            ttype = body[off]
            size = _u24(body, off + 1)
            ts = _u24(body, off + 4) | (body[off + 7] << 24)
            if off + 11 + size + 4 > len(body):
                break
            if base_ts is None:
                base_ts = ts
            sub_ts = (msg.timestamp + (ts - base_ts)) & 0xFFFFFFFF
            sub = RtmpMessage(ttype, sub_ts, msg.msid,
                              body[off + 11:off + 11 + size])
            self._dispatch(sub)
            off += 11 + size + 4

    def _on_data(self, msg: RtmpMessage, vals: List[Any]) -> None:
        if not vals:
            return
        name = vals[0] if isinstance(vals[0], str) else ""
        rest = vals[1:]
        if name == "@setDataFrame" and rest:      # publisher relays meta
            name = rest[0] if isinstance(rest[0], str) else name
            rest = rest[1:]
        meta = next((v for v in rest if isinstance(v, dict)), None)
        s = self._streams.get(msg.msid)
        if s is not None and meta is not None:
            s._deliver(s.on_meta_data, dict(meta), name)

    # ---- command handling ---------------------------------------------

    def _on_command(self, msg: RtmpMessage, vals: List[Any]) -> None:
        name = vals[0] if isinstance(vals[0], str) else ""
        if self.is_server:
            self._on_server_command(msg, name, vals)
        else:
            self._on_client_command(msg, name, vals)

    def _txn(self, vals: List[Any]) -> float:
        return float(vals[1]) if len(vals) > 1 and isinstance(
            vals[1], (int, float)) else 0.0

    def _on_server_command(self, msg: RtmpMessage, name: str,
                           vals: List[Any]) -> None:
        txn = self._txn(vals)
        if name == "connect":
            if len(vals) > 2 and isinstance(vals[2], dict):
                self.connect_info = dict(vals[2])
            self._send_control(MSG_WINDOW_ACK_SIZE,
                               struct.pack(">I", DEFAULT_WINDOW_ACK_SIZE))
            self._send_control(MSG_SET_PEER_BANDWIDTH,
                               struct.pack(">IB", DEFAULT_WINDOW_ACK_SIZE,
                                           2))
            self.set_out_chunk_size(OUT_CHUNK_SIZE)
            self._send_control(MSG_USER_CONTROL,
                               struct.pack(">HI", UC_STREAM_BEGIN, 0))
            self._send_command(
                CSID_COMMAND, 0, "_result", txn,
                {"fmsVer": "FMS/3,5,3,824", "capabilities": 127.0},
                {"level": "status",
                 "code": "NetConnection.Connect.Success",
                 "description": "Connection succeeded.",
                 "objectEncoding": 0.0})
        elif name == "createStream":
            with self._streams_lock:
                msid = self._next_msid
                self._next_msid += 1
            self._send_command(CSID_COMMAND, 0, "_result", txn, None,
                               float(msid))
        elif name in ("releaseStream", "FCPublish", "FCUnpublish",
                      "getStreamLength"):
            self._send_command(CSID_COMMAND, 0, "_result", txn, None,
                               amf.UNDEFINED)
        elif name == "publish":
            sname = vals[3] if len(vals) > 3 and isinstance(vals[3], str) \
                else ""
            ptype = vals[4] if len(vals) > 4 and isinstance(vals[4], str) \
                else "live"
            self._server_open_stream(msg.msid, "publish", sname, ptype)
        elif name == "play":
            sname = vals[3] if len(vals) > 3 and isinstance(vals[3], str) \
                else ""
            self._server_open_stream(msg.msid, "play", sname, "")
        elif name == "deleteStream":
            msid = int(vals[3]) if len(vals) > 3 and isinstance(
                vals[3], (int, float)) else 0
            self._drop_stream(msid, notify=True)
        elif name == "closeStream":
            self._drop_stream(msg.msid, notify=True)
        # unknown commands are ignored (the reference logs and continues)

    def _server_open_stream(self, msid: int, what: str, sname: str,
                            ptype: str) -> None:
        svc = getattr(self.server, "_rtmp_service", None)
        if svc is None or msid == 0:
            self._send_status(msid, "error", "NetStream.Failed",
                              "no rtmp service")
            return
        with self._streams_lock:
            stream = self._streams.get(msid)
            if stream is None:
                stream = svc.new_stream(self.socket.remote_side,
                                        self.connect_info)
                stream._conn = self
                stream.stream_id = msid
                stream.remote_side = self.socket.remote_side
                self._streams[msid] = stream

        def accept():
            if what == "publish":
                rc = stream.on_publish(sname, ptype)
                if rc == 0:
                    stream.publish_name = sname
                    self._send_status(msid, "status",
                                      "NetStream.Publish.Start",
                                      f"Publishing {sname}.")
                else:
                    self._send_status(msid, "error",
                                      "NetStream.Publish.BadName",
                                      f"Rejected {sname}.")
            else:
                rc = stream.on_play(sname)
                if rc == 0:
                    stream.play_name = sname
                    self._send_control(
                        MSG_USER_CONTROL,
                        struct.pack(">HI", UC_STREAM_BEGIN, msid))
                    self._send_status(msid, "status",
                                      "NetStream.Play.Reset",
                                      f"Resetting {sname}.")
                    self._send_status(msid, "status",
                                      "NetStream.Play.Start",
                                      f"Started playing {sname}.")
                else:
                    self._send_status(msid, "error",
                                      "NetStream.Play.StreamNotFound",
                                      f"No stream {sname}.")
        stream._deliver(accept)          # ordered before subsequent AV

    def _on_client_command(self, msg: RtmpMessage, name: str,
                           vals: List[Any]) -> None:
        if name in ("_result", "_error"):
            txn = int(self._txn(vals))
            with self._pending_lock:
                pending = self._pending.pop(txn, None)
            if pending is not None:
                ev, box = pending
                box.append(name)
                box.extend(vals[2:])
                ev.signal()
            elif txn == 1:               # the connect transaction
                self.connect_error = 0 if name == "_result" else \
                    errors.EREQUEST
                self.connected.signal()
        elif name == "onStatus":
            info = next((v for v in vals[2:] if isinstance(v, dict)), {})
            s = self._streams.get(msg.msid)
            if isinstance(s, RtmpClientStream):
                s._on_status(dict(info))
        elif name == "onBWDone":
            pass

    def _on_client_established(self) -> None:
        """Handshake finished (client): send connect(txn=1)."""
        self.set_out_chunk_size(OUT_CHUNK_SIZE)
        info = dict(self._connect_request)
        self._send_command(CSID_COMMAND, 0, "connect", 1.0, info)

    # ---- lifecycle -----------------------------------------------------

    def _drop_stream(self, msid: int, notify: bool = False) -> None:
        with self._streams_lock:
            s = self._streams.pop(msid, None)
        if s is not None and notify:
            s._shutdown()

    def _on_socket_failed(self, socket) -> None:
        self.connect_error = self.connect_error or errors.EFAILEDSOCKET
        self.connected.signal()
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for ev, box in pending:
            box.append("_error")
            ev.signal()
        with self._streams_lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            if isinstance(s, RtmpClientStream):
                s._on_status({"level": "error",
                              "code": "NetConnection.Closed",
                              "description": "connection lost"})
            s._shutdown()


# ---- client ------------------------------------------------------------

class RtmpClientOptions:
    def __init__(self, app: str = "live", tc_url: str = "",
                 flash_ver: str = "brpc_tpu/1.0", swf_url: str = "",
                 page_url: str = "", timeout: float = 5.0):
        self.app = app
        self.tc_url = tc_url
        self.flash_ver = flash_ver
        self.swf_url = swf_url
        self.page_url = page_url
        self.timeout = timeout


class RtmpClient:
    """NetConnection owner (rtmp.h RtmpClient:880-940): one TCP+RTMP
    connection; create_stream() yields RtmpClientStream handles."""

    def __init__(self, address: Any,
                 options: Optional[RtmpClientOptions] = None):
        self.options = options or RtmpClientOptions()
        ep = address if isinstance(address, EndPoint) else \
            parse_endpoint(address if "://" in str(address)
                           else f"tcp://{address}")
        from ..rpc.input_messenger import InputMessenger
        from ..rpc.tcp_transport import tcp_connect
        self._socket = tcp_connect(ep, timeout=self.options.timeout)
        self._socket.messenger = InputMessenger(protocols=[RTMP_PROTOCOL])
        conn = RtmpConnection(self._socket, is_server=False)
        tc_url = self.options.tc_url or \
            f"rtmp://{ep.host}:{ep.port}/{self.options.app}"
        conn._connect_request = {
            "app": self.options.app,
            "flashVer": self.options.flash_ver,
            "swfUrl": self.options.swf_url,
            "tcUrl": tc_url,
            "fpad": False,
            "audioCodecs": 3575.0,
            "videoCodecs": 252.0,
            "videoFunction": 1.0,
            "pageUrl": self.options.page_url,
            "objectEncoding": 0.0,
        }
        self._conn = conn
        self._socket._rtmp_conn = conn
        conn._start_client_handshake()
        if conn.connected.wait(self.options.timeout) != 0:
            self._socket.set_failed(errors.ERPCTIMEDOUT, "rtmp connect")
            raise TimeoutError("RTMP connect timed out")
        if conn.connect_error:
            self._socket.set_failed(conn.connect_error, "rtmp connect")
            raise ConnectionError(
                f"RTMP connect failed: {errors.berror(conn.connect_error)}")

    def create_stream(self, stream: Optional[RtmpClientStream] = None,
                      timeout: float = 5.0) -> RtmpClientStream:
        result, err = self._conn.call_command("createStream", None,
                                              timeout=timeout)
        if err or not result or not isinstance(result[-1], (int, float)):
            raise ConnectionError("createStream failed")
        msid = int(result[-1])
        s = stream or RtmpClientStream()
        s._conn = self._conn
        s.stream_id = msid
        with self._conn._streams_lock:
            self._conn._streams[msid] = s
        return s

    @property
    def connect_info(self) -> Dict[str, Any]:
        return self._conn.connect_info

    def stop(self) -> None:
        self._socket.set_failed(errors.ECLOSE, "client stopped")


# ---- protocol registration ---------------------------------------------

def parse(source: IOBuf, socket, read_eof: bool, arg) -> ParseResult:
    conn = getattr(socket, "_rtmp_conn", None)
    if conn is None:
        server = getattr(arg, "server", None)
        if server is None or getattr(server, "_rtmp_service", None) is None:
            return ParseResult.try_others()
        first = source.fetch1()
        if first is None:
            return ParseResult.not_enough_data()
        if first != RTMP_VERSION:
            return ParseResult.try_others()
        # C0 alone is ambiguous with very short binary frames; require C1
        # to begin arriving before claiming the connection
        if len(source) < 2:
            return ParseResult.not_enough_data()
        conn = RtmpConnection(socket, is_server=True, server=server)
        socket._rtmp_conn = conn
    if not conn.consume(source):
        return ParseResult.parse_error("rtmp protocol error")
    return ParseResult.not_enough_data()


RTMP_PROTOCOL = Protocol(
    name="rtmp",
    parse=parse,
    supported_connection_type=CONNECTION_TYPE_SINGLE,
    support_client=True,
    support_server=True,
)


def _register() -> None:
    from ..rpc.protocol import find_protocol
    if find_protocol("rtmp") is None:
        register_protocol(RTMP_PROTOCOL)


_register()
