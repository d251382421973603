"""A small memcached speaking the binary protocol on a TCP port.

The memcache protocol is client-only here, as in the reference (a brpc
server does not answer memcached frames), so the memcache client needs a
memcached to call.  This one keeps its items in a dict and answers GET,
SET, ADD, REPLACE, DELETE, INCREMENT, DECREMENT, VERSION, NOOP and SASL
PLAIN AUTH with the status codes of the memcached binary spec; frames are
served in order on each connection, one thread per connection.

Usage:
    mc = MiniMemcached().start()          # binds 127.0.0.1:0
    ch.init(f"127.0.0.1:{mc.port}", options=ChannelOptions(
        protocol="memcache"))
    ...
    mc.stop()
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

_HDR = struct.Struct(">BBHBBHIIQ")
MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81
OP_GET, OP_SET, OP_ADD, OP_REPLACE, OP_DELETE = 0x00, 0x01, 0x02, 0x03, 0x04
OP_INCREMENT, OP_DECREMENT, OP_NOOP, OP_VERSION = 0x05, 0x06, 0x0A, 0x0B
OP_SASL_AUTH = 0x21
STATUS_OK, STATUS_KEY_NOT_FOUND, STATUS_KEY_EXISTS = 0x00, 0x01, 0x02
STATUS_NOT_STORED, STATUS_AUTH_ERROR = 0x05, 0x20
STATUS_UNKNOWN_COMMAND = 0x81
VERSION = b"1.6.0-mini"


class MiniMemcached:
    def __init__(self, host: str = "127.0.0.1", sasl: bytes = b""):
        self.host = host
        self.sasl = sasl                  # b"\0user\0password" when set
        self.data: Dict[bytes, Tuple[bytes, int]] = {}   # key -> (v, flags)
        self.frames = 0
        self._lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self.port = 0

    def start(self) -> "MiniMemcached":
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, 0))
        ls.listen(64)
        self._listener = ls
        self.port = ls.getsockname()[1]
        t = threading.Thread(target=self._accept, name="mini_memcached",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            ls.close()
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(5)

    def _accept(self) -> None:
        while self._listener is not None:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="mini_memcached_conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        buf = b""
        while True:
            try:
                chunk = conn.recv(1 << 16)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            out = []
            pos = 0
            while pos + 24 <= len(buf):
                if buf[pos] != MAGIC_REQUEST:
                    conn.close()
                    return
                blen = _HDR.unpack_from(buf, pos)[6]
                if pos + 24 + blen > len(buf):
                    break
                out.append(self.handle(buf[pos:pos + 24 + blen]))
                pos += 24 + blen
            buf = buf[pos:]
            if out:
                try:
                    conn.sendall(b"".join(out))
                except OSError:
                    return

    def handle(self, frame: bytes) -> bytes:
        """One request frame -> its response frame."""
        (_magic, op, keylen, extlen, _dt, _vb, blen, opaque,
         cas) = _HDR.unpack_from(frame, 0)
        body = frame[24:24 + blen]
        extras = body[:extlen]
        key = body[extlen:extlen + keylen]
        value = body[extlen + keylen:]
        status, rext, rval = STATUS_OK, b"", b""
        with self._lock:
            self.frames += 1
            if op == OP_GET:
                item = self.data.get(key)
                if item is None:
                    status = STATUS_KEY_NOT_FOUND
                else:
                    rval, flags = item
                    rext = struct.pack(">I", flags)
            elif op in (OP_SET, OP_ADD, OP_REPLACE):
                flags = struct.unpack(">I", extras[:4])[0] if extras else 0
                exists = key in self.data
                if (op == OP_ADD and exists) or (op == OP_REPLACE
                                                 and not exists):
                    status = STATUS_KEY_EXISTS if exists \
                        else STATUS_NOT_STORED
                else:
                    self.data[key] = (value, flags)
            elif op == OP_DELETE:
                if self.data.pop(key, None) is None:
                    status = STATUS_KEY_NOT_FOUND
            elif op in (OP_INCREMENT, OP_DECREMENT):
                delta, initial, _exp = struct.unpack(">QQI", extras)
                item = self.data.get(key)
                if item is None:
                    cur = initial
                elif op == OP_INCREMENT:
                    cur = (int(item[0]) + delta) & 0xFFFFFFFFFFFFFFFF
                else:
                    cur = max(int(item[0]) - delta, 0)
                self.data[key] = (str(cur).encode(), 0)
                rval = struct.pack(">Q", cur)
            elif op == OP_VERSION:
                rval = VERSION
            elif op == OP_NOOP:
                pass
            elif op == OP_SASL_AUTH:
                if self.sasl and value != self.sasl:
                    status = STATUS_AUTH_ERROR
            else:
                status = STATUS_UNKNOWN_COMMAND
        return _HDR.pack(MAGIC_RESPONSE, op, 0, len(rext), 0, status,
                         len(rext) + len(rval), opaque, cas) + rext + rval
