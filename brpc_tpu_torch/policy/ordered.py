"""Responses in request order on one connection.

A protocol whose replies carry no id (HTTP/1.1, redis's pipelined
commands) must answer a connection's requests in the order they came,
while the messenger dispatches each cut message concurrently.  The reader
numbers each request as it is cut (``number``, from the protocol's
``process_inline``), and ``write`` holds a finished reply until every
earlier one on the connection has left (``InOrder`` is a request's socket
whose writes go through it).
"""
from __future__ import annotations

import threading

from ..butil.iobuf import IOBuf


class _Order:
    __slots__ = ("lock", "pending", "next_in", "next_out")

    def __init__(self):
        self.lock = threading.Lock()
        self.pending = {}
        self.next_in = 0
        self.next_out = 0


def number(socket) -> int:
    """The next request's place on ``socket`` (reader thread only)."""
    order = getattr(socket, "_reply_order", None)
    if order is None:
        order = socket._reply_order = _Order()
    seq = order.next_in
    order.next_in += 1
    return seq


def write(socket, seq: int, buf: IOBuf) -> int:
    """Write request ``seq``'s reply once every earlier reply has left;
    a later reply that finished first waits here for its turn."""
    order = socket._reply_order
    rc = 0
    with order.lock:
        order.pending[seq] = buf
        # the lock spans the writes: two handlers finishing at once must
        # not interleave their turns
        while order.next_out in order.pending:
            out = order.pending.pop(order.next_out)
            order.next_out += 1
            rc = socket.write(out) or rc
    return rc


class InOrder:
    """A request's socket whose ``write`` takes the request's turn: the
    handler writes its response as to the socket itself."""

    __slots__ = ("_sock", "_seq")

    def __init__(self, sock, seq: int):
        self._sock = sock
        self._seq = seq

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def write(self, buf: IOBuf, **kw) -> int:
        return write(self._sock, self._seq, buf)
