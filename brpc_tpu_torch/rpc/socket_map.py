"""SocketMap: process-global EndPoint → single-connection cache.

Reference: src/brpc/socket_map.{h,cpp} (SocketMapInsert :82,
SingleConnection :180).  Channels to the same endpoint share one "single"
connection; a failed socket, or one whose peer sent GOODBYE, is replaced
on next use.  This slice connects
``ici://`` and ``mem://`` endpoints only.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..butil.endpoint import EndPoint, SCHEME_ICI, SCHEME_MEM
from . import errors
from .socket import Socket


class _SingleConnection:
    def __init__(self):
        self.socket: Optional[Socket] = None
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

    def get_socket(self, ep: EndPoint, messenger=None,
                   group: Any = "") -> Socket:
        """The shared 'single' connection to ep (creates/replaces lazily)."""
        e = self._entry(ep, group)
        with e.lock:
            if e.socket is not None and not e.socket.failed \
                    and not e.socket.logoff:
                return e.socket
            s = self._connect(ep)
            s.messenger = messenger
            e.socket = s
            return s

    @staticmethod
    def _connect(ep: EndPoint) -> Socket:
        if ep.scheme == SCHEME_ICI:
            from ..ici.transport import ici_connect
            return ici_connect(ep)
        if ep.scheme == SCHEME_MEM:
            from .mem_transport import mem_connect
            return mem_connect(ep.host)
        raise ValueError(f"unsupported scheme {ep.scheme}")

    def close_endpoint(self, ep: EndPoint, group: Any = "") -> None:
        """Fail and drop the connection held for (ep, group): client
        teardown (Channel.close)."""
        with self._lock:
            e = self._map.pop((ep, group), None)
        if e is None:
            return
        with e.lock:
            s, e.socket = e.socket, None
        if s is not None:
            s.set_failed(errors.ECLOSE, "channel closed")
