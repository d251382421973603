"""TCP transport (the DCN / inter-slice path) and its Acceptor.

Port of :mod:`brpc_tpu.rpc.tcp_transport` (reference Socket fd IO,
socket.cpp DoWrite :1790 writev batching and HandleEpollOut :1336; Acceptor,
acceptor.cpp OnNewConnections :243, :327).  Non-blocking fds driven by the
:mod:`.event_dispatcher`; KeepWrite blocks on a butex that EPOLLOUT wakes.

A DEVICE attachment crosses a TCP socket the way it does in the JAX
package: as host bytes on the wire.  :meth:`~..butil.iobuf.Block.
host_view` makes the one device-to-host copy, and the receiver gets host
bytes.  This is the host network path, not the device plane.  TLS
(``ssl_context``) is not ported.
"""
from __future__ import annotations

import socket as pysocket
import threading
from typing import Callable, Optional

from ..butil.endpoint import EndPoint, SCHEME_TCP
from ..butil.iobuf import IOBuf, IOPortal
from ..bthread.butex import ETIMEDOUT, Butex
from . import errors
from .socket import Socket


class TcpSocket(Socket):
    def __init__(self, sock: pysocket.socket,
                 remote_side: Optional[EndPoint] = None):
        super().__init__(remote_side)
        self.sock = sock
        self.sock.setblocking(False)
        try:
            self.sock.setsockopt(pysocket.IPPROTO_TCP,
                                 pysocket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._writable_butex = Butex(0)
        self._dispatcher = None
        self._fd = sock.fileno()
        try:
            h, p = sock.getsockname()[:2]
            self.local_side = EndPoint(scheme=SCHEME_TCP, host=h, port=p)
        except OSError:
            pass

    def register_with_dispatcher(self) -> None:
        from .event_dispatcher import get_global_dispatcher
        self._dispatcher = get_global_dispatcher(self._fd)
        self._dispatcher.add_consumer(self._fd, self.id)

    # ---- transport hooks ----------------------------------------------
    def _do_write(self, data: IOBuf) -> int:
        try:
            return data.cut_into_file_descriptor(self._fd)
        except (BlockingIOError, InterruptedError):
            return -1

    def _do_read(self, portal: IOPortal, max_count: int) -> int:
        return portal.append_from_socket(self.sock, max_count)

    def _wait_writable(self, timeout: float = 30.0) -> bool:
        self._writable_butex.set_value(0)
        self._dispatcher.add_epollout(self._fd, self.id)
        # EWOULDBLOCK: EPOLLOUT fired before this thread queued
        if self._writable_butex.wait(0, timeout) == ETIMEDOUT:
            # a peer that stopped reading must not hold the writer role
            # (and every queued write) forever
            self.set_failed(errors.EFAILEDSOCKET,
                            f"tcp send stalled >{timeout:.0f}s")
        return not self.failed

    def handle_epollout(self) -> None:
        self._writable_butex.wake_all_and_set(1)

    def _transport_close(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.remove_consumer(self._fd)
        self._writable_butex.wake_all_and_set(1)
        try:
            self.sock.close()
        except OSError:
            pass


def tcp_connect(ep: EndPoint, timeout: Optional[float] = 5.0) -> TcpSocket:
    """Connect to ``ep`` within ``timeout`` seconds (None waits as long as
    the kernel does): ``ChannelOptions.connect_timeout_ms`` lands here."""
    raw = pysocket.create_connection((ep.host, ep.port), timeout=timeout)
    s = TcpSocket(raw, remote_side=ep)
    s.register_with_dispatcher()
    return s


class Acceptor:
    """Listener: accepts connections and wraps each in a TcpSocket bound
    to the server's InputMessenger (acceptor.cpp)."""

    def __init__(self, on_accept: Callable[[TcpSocket], None]):
        self.on_accept = on_accept
        self.listen_sock: Optional[pysocket.socket] = None
        self.port = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        ls = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        ls.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
        try:
            ls.bind((host, port))
            ls.listen(128)
        except OSError:
            ls.close()
            raise
        ls.settimeout(0.5)
        self.listen_sock = ls
        self.port = ls.getsockname()[1]
        # a dedicated thread stands in for the listen fd's dispatcher event
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="acceptor", daemon=True)
        self._thread.start()
        return self.port

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, addr = self.listen_sock.accept()
            except pysocket.timeout:
                continue
            except OSError:
                return
            s = TcpSocket(conn, remote_side=EndPoint(
                scheme=SCHEME_TCP, host=addr[0], port=addr[1]))
            s.is_server_side = True
            try:
                self.on_accept(s)
                s.register_with_dispatcher()
                s.start_input_event()   # data may already be buffered
            except Exception:
                s.set_failed(errors.EINTERNAL, "accept handling failed")

    def stop(self) -> None:
        self._stop = True
        if self.listen_sock is not None:
            try:
                self.listen_sock.close()
            except OSError:
                pass
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)
