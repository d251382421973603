"""Server: service registry + lifecycle over the ici:// transport.

Reference: src/brpc/server.{h,cpp} (StartInternal :741, AddService :1477).
A server listens on one ``ici://k`` endpoint (a rank of the mesh) or one
``mem://name`` endpoint (the in-process loopback) and exposes its
registered services through tpu_std.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..butil.endpoint import parse_endpoint, SCHEME_ICI, SCHEME_MEM
from ..butil import logging as log
from . import errors
from .input_messenger import InputMessenger
from .service import MethodDescriptor, Service


@dataclass
class ServerOptions:
    # Run user handlers directly on the delivering thread (the device
    # completion poller for payloads that rode the device plane) instead
    # of a scheduler tasklet.  Minimal latency; only safe when handlers
    # are fast and non-blocking.
    usercode_inline: bool = False


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Service] = {}
        self._methods: Dict[str, MethodDescriptor] = {}
        self._started = False
        self._ici_listener = None
        self._mem_listener = None
        self.listen_endpoint = None
        self.messenger = InputMessenger(server=self)
        self._connections: List[Any] = []
        self._conn_lock = threading.Lock()

    # ---- registry -----------------------------------------------------
    def add_service(self, svc: Service) -> int:
        if self._started:
            raise RuntimeError("cannot add service after start")
        name = svc.service_name()
        if name in self._services:
            return errors.EINVAL
        self._services[name] = svc
        for md in svc.methods().values():
            self._methods[md.full_name] = md
        return 0

    def find_method(self, full_name: str) -> Optional[MethodDescriptor]:
        return self._methods.get(full_name)

    def services(self) -> Dict[str, Service]:
        return dict(self._services)

    # ---- lifecycle ----------------------------------------------------
    def start(self, addr: Any) -> int:
        """Listen on ``ici://k`` or ``mem://name`` (a string or an
        EndPoint)."""
        if self._started:
            return errors.EINVAL
        ep = parse_endpoint(addr) if isinstance(addr, str) else addr
        if ep.scheme == SCHEME_ICI:
            from ..ici.transport import ici_listen
            self._ici_listener = ici_listen(ep.device_id, self._on_accept)
        elif ep.scheme == SCHEME_MEM:
            from .mem_transport import mem_listen
            self._mem_listener = mem_listen(ep.host, self._on_accept)
        else:
            raise ValueError(f"cannot listen on scheme {ep.scheme}: the "
                             "port serves ici:// and mem:// only")
        self.listen_endpoint = ep
        with self._conn_lock:
            self._connections = []
        self._started = True
        log.info("Server started on %s with %d services", ep,
                 len(self._services))
        return 0

    def _on_accept(self, sock) -> None:
        sock.messenger = self.messenger
        sock.usercode_inline = self.options.usercode_inline
        with self._conn_lock:
            self._connections = [s for s in self._connections if not s.failed]
            self._connections.append(sock)

    def stop(self) -> int:
        """Stop listening and fail every accepted connection with ELOGOFF
        (their clients' in-flight calls complete with it)."""
        if not self._started:
            return 0
        if self._ici_listener is not None:
            from ..ici.transport import ici_unlisten
            ici_unlisten(self._ici_listener.device_id)
            self._ici_listener = None
        if self._mem_listener is not None:
            from .mem_transport import mem_unlisten
            mem_unlisten(self._mem_listener.name)
            self._mem_listener = None
        with self._conn_lock:
            conns, self._connections = self._connections, []
        for s in conns:
            s.set_failed(errors.ELOGOFF, "server stopping")
        self._started = False
        return 0
