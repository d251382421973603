"""TCP transport (the DCN / inter-slice path) and its Acceptor.

Port of :mod:`brpc_tpu.rpc.tcp_transport` (reference Socket fd IO,
socket.cpp DoWrite :1790 writev batching and HandleEpollOut :1336; Acceptor,
acceptor.cpp OnNewConnections :243, :327).  Non-blocking fds driven by the
:mod:`.event_dispatcher`; KeepWrite blocks on a butex that EPOLLOUT wakes.

A DEVICE attachment crosses a TCP socket the way it does in the JAX
package: as host bytes on the wire.  :meth:`~..butil.iobuf.Block.
host_view` makes the one device-to-host copy, and the receiver gets host
bytes.  This is the host network path, not the device plane.

TLS (reference details/ssl_helper.cpp and the Socket's SSL state machine):
pass an ``ssl.SSLContext`` to :func:`tcp_connect` or the :class:`Acceptor`.
The handshake runs blocking at connect or accept, then the wrapped socket
joins the non-blocking loop.  Its bytes leave through ``SSLSocket.send``,
one ref at a time (a raw ``writev`` on its fd would put plaintext on the
wire), and ``SSLWantReadError``/``SSLWantWriteError`` mean EAGAIN on both
sides.  A DEVICE ref is viewed on the host a slice at a time
(:data:`TLS_DEVICE_SLICE`), so a partial send never copies the rest of the
block again.  A lock keeps the reader and a writer out of the TLS object
at the same time.
"""
from __future__ import annotations

import socket as pysocket
import ssl
import threading
from typing import Callable, Optional

from ..butil.endpoint import EndPoint, SCHEME_TCP
from ..butil.iobuf import DEVICE, IOBuf, IOPortal
from ..bthread.butex import ETIMEDOUT, Butex
from . import errors
from .socket import Socket

# the most of a DEVICE ref one TLS send views on the host
TLS_DEVICE_SLICE = 256 << 10


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
        self._tls = isinstance(sock, ssl.SSLSocket)
        # one OpenSSL connection object must not read and write on two
        # threads at once (the reader tasklet and a writer): its record
        # state is not thread-safe
        self._tls_lock = threading.Lock() if self._tls else None
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
        if self._tls:
            return self._tls_write(data)
        try:
            return data.cut_into_file_descriptor(self._fd)
        except (BlockingIOError, InterruptedError):
            return -1

    def _tls_write(self, data: IOBuf) -> int:
        """Send the leading ref (a slice of it when DEVICE) through the
        TLS record layer; pops what was sent."""
        if data.empty():
            return 0
        r = data.backing_block(0)
        n = r.length
        if r.block.kind == DEVICE:
            n = min(n, TLS_DEVICE_SLICE)
        view = r.block.host_view(r.offset, n)
        try:
            with self._tls_lock:
                sent = self.sock.send(view)
        except (ssl.SSLWantWriteError, ssl.SSLWantReadError,
                BlockingIOError, InterruptedError):
            return -1
        if sent > 0:
            data.pop_front(sent)
        return sent

    def _do_read(self, portal: IOPortal, max_count: int) -> int:
        if not self._tls:
            return portal.append_from_socket(self.sock, max_count)
        # a TLS socket may hold decrypted bytes after its fd stopped being
        # readable: the messenger reads until this returns -1
        try:
            with self._tls_lock:
                return portal.append_from_socket(self.sock, max_count)
        except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
            return -1

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


def tcp_connect(ep: EndPoint, timeout: Optional[float] = 5.0,
                ssl_context=None, server_hostname: str = "") -> TcpSocket:
    """Connect to ``ep`` within ``timeout`` seconds (None waits as long as
    the kernel does): ``ChannelOptions.connect_timeout_ms`` lands here.
    With ``ssl_context`` the TLS handshake runs within the same limit."""
    raw = pysocket.create_connection((ep.host, ep.port), timeout=timeout)
    if ssl_context is not None:
        try:
            raw = ssl_context.wrap_socket(
                raw, server_hostname=server_hostname or ep.host)
        except Exception:
            raw.close()
            raise
    s = TcpSocket(raw, remote_side=ep)
    s.register_with_dispatcher()
    return s


class Acceptor:
    """Listener: accepts connections and wraps each in a TcpSocket bound
    to the server's InputMessenger (acceptor.cpp); with ``ssl_context``
    each connection handshakes TLS first."""

    def __init__(self, on_accept: Callable[[TcpSocket], None],
                 ssl_context=None):
        self.on_accept = on_accept
        self.ssl_context = ssl_context
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
            if self.ssl_context is not None:
                # the handshake runs inline with a 5 s limit: a client
                # that never handshakes (a plaintext one) holds this
                # accept loop until then
                try:
                    conn.settimeout(5.0)
                    conn = self.ssl_context.wrap_socket(conn,
                                                        server_side=True)
                except Exception:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
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
