"""SocketMap: process-global EndPoint → connection cache.

Reference: src/brpc/socket_map.{h,cpp} (SocketMapInsert :82,
SingleConnection :180, GetPooledSocket).  Channels to the same endpoint
share one "single" connection; a failed socket, or one whose peer sent
GOODBYE, is replaced on next use.  Pooled connections hang off the same
entry: a call takes one for itself and returns it when it ends, and a
short connection serves one call and closes.  A connect that fails hands
the endpoint to the health checker before the error propagates.  The port
connects ``ici://`` (a rank another process owns through the fabric,
:func:`..ici.fabric.connect_any`), ``mem://`` and TCP endpoints; a TCP
connect waits at most the channel's ``connect_timeout_ms``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..butil.endpoint import EndPoint, SCHEME_ICI, SCHEME_MEM, SCHEME_TCP
from . import errors
from .socket import Socket


class _SingleConnection:
    def __init__(self):
        self.socket: Optional[Socket] = None
        self.pooled: List[Socket] = []       # idle pooled connections
        self.lock = threading.Lock()


class SocketMap:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._map: Dict[tuple, _SingleConnection] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "SocketMap":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = SocketMap()
            return cls._instance

    def _entry(self, ep: EndPoint, group: Any = "") -> _SingleConnection:
        # key = (endpoint, channel signature): channels speaking different
        # protocols to one endpoint must not share a connection (reference
        # channel.cpp ComputeChannelSignature)
        key = (ep, group)
        with self._lock:
            e = self._map.get(key)
            if e is None:
                e = _SingleConnection()
                self._map[key] = e
            return e

    def get_socket(self, ep: EndPoint, messenger=None, group: Any = "",
                   connect_timeout: Optional[float] = 5.0) -> Socket:
        """The shared 'single' connection to ep (creates/replaces lazily)."""
        e = self._entry(ep, group)
        with e.lock:
            if e.socket is not None and not e.socket.failed \
                    and not e.socket.logoff:
                return e.socket
            s = self._checked_connect(ep, connect_timeout)
            s.messenger = messenger
            e.socket = s
            return s

    def get_pooled_socket(self, ep: EndPoint, messenger=None,
                          group: Any = "",
                          connect_timeout: Optional[float] = 5.0) -> Socket:
        """A connection for one call alone, from the pool or new
        (reference GetPooledSocket); the call gives it back with
        :meth:`return_pooled_socket`."""
        e = self._entry(ep, group)
        with e.lock:
            while e.pooled:
                s = e.pooled.pop()
                if not s.failed and not s.logoff:
                    return s
        s = self._checked_connect(ep, connect_timeout)
        s.messenger = messenger
        return s

    def return_pooled_socket(self, ep: EndPoint, s: Socket,
                             group: Any = "") -> None:
        if s.failed or s.logoff:
            return
        # no entry is created here: close_endpoint() pops it, and a socket
        # checked out across the close is failed on return instead of
        # bringing the entry back
        with self._lock:
            e = self._map.get((ep, group))
        if e is None:
            s.set_failed(errors.ECLOSE, "endpoint closed while checked out")
            return
        with e.lock:
            e.pooled.append(s)

    def get_short_socket(self, ep: EndPoint, messenger=None,
                         connect_timeout: Optional[float] = 5.0) -> Socket:
        """A new connection for one call, closed when the call ends."""
        s = self._checked_connect(ep, connect_timeout)
        s.messenger = messenger
        return s

    @classmethod
    def _checked_connect(cls, ep: EndPoint,
                         connect_timeout: Optional[float] = 5.0) -> Socket:
        """``_connect``, but an endpoint that refuses is handed to the
        health checker before the error propagates (the reference starts
        a health check whenever a connect fails): a failed connect makes
        no socket, so the socket-failure hand-off alone would miss the
        retries issued while the peer is down."""
        try:
            return cls._connect(ep, connect_timeout)
        except Exception:
            try:
                from .health_check import start_health_check
                start_health_check(ep)
            except Exception:
                pass
            raise

    @staticmethod
    def _connect(ep: EndPoint,
                 connect_timeout: Optional[float] = 5.0) -> Socket:
        if ep.scheme == SCHEME_ICI:
            # an in-process rank rides the IciSocket, one another process
            # owns the fabric
            from ..ici.fabric import connect_any
            return connect_any(ep)
        if ep.scheme == SCHEME_MEM:
            from .mem_transport import mem_connect
            return mem_connect(ep.host)
        if ep.scheme == SCHEME_TCP:
            from .tcp_transport import tcp_connect
            return tcp_connect(ep, timeout=connect_timeout)
        raise ValueError(f"unsupported scheme {ep.scheme}")

    def remove(self, ep: EndPoint, group: Any = "") -> None:
        """Forget (ep, group) without failing its connections."""
        with self._lock:
            self._map.pop((ep, group), None)

    def close_endpoint(self, ep: EndPoint, group: Any = "") -> None:
        """Fail and drop every connection held for (ep, group), the single
        one and the idle pooled ones: client teardown (Channel.close)."""
        with self._lock:
            e = self._map.pop((ep, group), None)
        if e is None:
            return
        with e.lock:
            socks = list(e.pooled)
            if e.socket is not None:
                socks.append(e.socket)
            e.socket = None
            e.pooled = []
        for s in socks:
            s.set_failed(errors.ECLOSE, "channel closed")

    def stats(self) -> Dict[EndPoint, int]:
        """Live connections held per endpoint: the single one and the
        idle pooled ones (short connections are not held)."""
        with self._lock:
            out: Dict[EndPoint, int] = {}
            for (ep, _group), e in self._map.items():
                out[ep] = out.get(ep, 0) + \
                    (0 if e.socket is None or e.socket.failed else 1) + \
                    len(e.pooled)
            return out
