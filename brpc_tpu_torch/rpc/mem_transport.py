"""mem:// loopback transport: in-process socket pairs.

Port of :mod:`brpc_tpu.rpc.mem_transport`.  A MemSocket pair moves IOBuf
bytes through an in-memory inbox with the readiness semantics of the other
transports (readable events, EOF on peer close, EAGAIN when drained).
DEVICE refs pass by reference: both ends live in one process, so a mem://
hop never moves device bytes (the serving router listens here and carries
only JSON).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..butil.iobuf import IOBuf, IOPortal
from ..butil.endpoint import EndPoint, SCHEME_MEM
from . import errors
from .socket import Socket


class MemSocket(Socket):
    def __init__(self, remote_side: Optional[EndPoint] = None):
        super().__init__(remote_side)
        self.peer: Optional["MemSocket"] = None
        self._inbox = IOBuf()
        self._inbox_lock = threading.Lock()
        self._peer_closed = False

    # transport hooks ---------------------------------------------------
    def _do_write(self, data: IOBuf) -> int:
        peer = self.peer
        if peer is None or peer.failed:
            raise ConnectionError("peer closed")
        n = len(data)
        chunk = data.cut(n)
        with peer._inbox_lock:
            peer._inbox.append(chunk)
        # responses (client-side peer) process inline on this thread —
        # framework code, bounded latency; requests (server-side peer)
        # go to a tasklet so user handlers can't block the writer
        inline = (not peer.is_server_side
                  or getattr(peer, "usercode_inline", False))
        peer.start_input_event(inline=inline)
        return n

    def _do_read(self, portal: IOPortal, max_count: int) -> int:
        with self._inbox_lock:
            avail = len(self._inbox)
            if avail == 0:
                return 0 if self._peer_closed else -1
            n = min(avail, max_count)
            self._inbox.cutn(portal, n)
            return n

    def _transport_close(self) -> None:
        peer = self.peer
        if peer is not None and not peer.failed:
            if self.failed_error == errors.ELOGOFF:
                # lame-duck hard stop: the peer's unanswered calls fail
                # with the retryable server code, on the EOF path after
                # the queued responses drain
                peer._eof_error_code = errors.ELOGOFF
            with peer._inbox_lock:
                peer._peer_closed = True
            peer.start_input_event()    # let it observe EOF


def new_mem_pair() -> tuple:
    a, b = MemSocket(), MemSocket()
    a.peer, b.peer = b, a
    return a, b


# ---- listener registry (the "network namespace" for mem://) -----------

_listeners: Dict[str, "MemListener"] = {}
_listeners_lock = threading.Lock()


class MemListener:
    """Server side of mem://name; hands accepted sockets to the server's
    acceptor logic (on_accept(server_socket))."""

    def __init__(self, name: str, on_accept):
        self.name = name
        self.on_accept = on_accept
        # set by a server's lame-duck drain: the listener still accepts
        # (new callers get the ELOGOFF bounce) but probes read it as down
        self.draining = False

    def connect(self, client_remote: EndPoint) -> MemSocket:
        client, serv = new_mem_pair()
        client.remote_side = client_remote
        serv.remote_side = EndPoint(scheme=SCHEME_MEM,
                                    host=self.name + "#client")
        serv.is_server_side = True
        self.on_accept(serv)
        return client


def mem_listen(name: str, on_accept) -> MemListener:
    with _listeners_lock:
        if name in _listeners:
            raise OSError(errors.EINVAL, f"mem://{name} already listening")
        listener = MemListener(name, on_accept)
        _listeners[name] = listener
        return listener


def mem_unlisten(name: str) -> None:
    with _listeners_lock:
        _listeners.pop(name, None)


def mem_connect(name: str) -> MemSocket:
    with _listeners_lock:
        listener = _listeners.get(name)
    if listener is None:
        raise ConnectionRefusedError(f"no server at mem://{name}")
    return listener.connect(EndPoint(scheme=SCHEME_MEM, host=name))
