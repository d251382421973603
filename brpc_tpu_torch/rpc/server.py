"""Server: service registry, admission and lame-duck lifecycle over the
ici://, mem:// and tcp:// transports.

Reference: src/brpc/server.{h,cpp} (StartInternal :741, AddService :1477,
Stop(closewait_ms)/Join), ported from :mod:`brpc_tpu.rpc.server`.  A
server listens on one ``ici://k`` endpoint (a rank of the mesh, reached
from other processes through :mod:`..ici.fabric`), one ``mem://name``
endpoint (the in-process loopback) or one ``host:port`` TCP endpoint
(``listen_port`` reads the bound port), and exposes its registered
services through tpu_std.  Around that:

  * ``internal_port``: an extra TCP listener on which the builtin admin
    pages alone are served; tpu_std is refused there (the HTTP pages wait
    for ``policy/http.py``);
  * ``idle_timeout_s``: a reaper closes connections with no read or write
    for that long;

  * per-method :class:`MethodStatus` with an optional concurrency limiter
    (``method_max_concurrency`` / ``concurrency_limiter``) and a
    server-wide ``max_concurrency`` gate;
  * an optional :class:`~.admission.AdmissionController` in front of the
    handlers (``ServerOptions.admission``);
  * an optional backup thread pool for handlers
    (``usercode_in_pthread``, :mod:`.usercode_pool`);
  * ``stop(grace_s)``: the lame-duck drain — new requests bounce with
    retryable ELOGOFF, peers get GOODBYE, in-flight handlers, queued
    usercode, open streams and posted device-plane transfers finish
    inside the grace window, and only stragglers are failed: a stream
    past the window gets an orderly CLOSE, not a reset;
  * the builtin admin pages as RPC services (``brpc_tpu.Builtin``,
    ``brpc_tpu.Trace``), mounted at start unless
    ``enable_builtin_services`` is off (:mod:`.builtin`);
  * ``register_collective``: a device-side body for a served method, run
    by the compiled collective fan-out while the server serves its
    ``ici://`` rank (:mod:`..channels.collective_fanout`);
  * ``register_isolated``: a method whose handler is SOURCE, run on the
    usercode pool's isolation workers (payload bytes in, response payload
    bytes out);
  * per-request session data from a pool
    (``session_local_data_factory``, read with
    ``Controller.session_local_data()``) and per-thread data
    (``thread_local_data_factory``, read with ``thread_local_data()``).
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..butil.endpoint import (EndPoint, parse_endpoint, SCHEME_ICI,
                               SCHEME_MEM, SCHEME_TCP)
from ..butil import logging as log
from . import errors
from .input_messenger import InputMessenger
from .method_status import MethodStatus
from .service import MethodDescriptor, Service


@dataclass
class ServerOptions:
    # Run user handlers directly on the delivering thread (the device
    # completion poller for payloads that rode the device plane) instead
    # of a scheduler tasklet.  Minimal latency; only safe when handlers
    # are fast and non-blocking.
    usercode_inline: bool = False
    max_concurrency: int = 0            # 0 = unlimited; else ELIMIT beyond
    # per-method limiter: {"Service.Method": n or "auto"}
    method_max_concurrency: Dict[str, Any] = field(default_factory=dict)
    concurrency_limiter: str = ""       # "", "constant", "auto", "timeout"
    # Run user handlers on a dedicated backup THREAD pool instead of
    # scheduler workers (the reference's usercode_in_pthread): the
    # scheduler compensates for workers parked in butexes, but a
    # CPU-bound handler never parks, and enough of them would occupy
    # every worker and stall unrelated sockets' reads.
    usercode_in_pthread: bool = False
    usercode_backup_threads: int = 8
    # isolation backend of the backup pool (rpc/usercode_pool.py): "auto",
    # "pthread" or "subinterp"; only handlers registered on the pool as
    # isolated run isolated
    usercode_pool_kind: str = "auto"
    # Lame-duck drain window applied by stop() when no explicit grace is
    # passed (reference Server::Stop(closewait_ms)); 0 = immediate stop.
    graceful_shutdown_s: float = 0.0
    # Install a process-wide SIGTERM hook that drains this server with
    # graceful_shutdown_s (reference -graceful_quit_on_sigterm).  A
    # second TERM during the drain kills immediately.
    graceful_quit_on_sigterm: bool = False
    # Overload admission control (rpc/admission.py): True uses the
    # AdmissionOptions defaults, an AdmissionOptions tunes bands, queue
    # bound and tenant weights; None/False keeps reject-at-gate.
    admission: Any = None
    # mount the builtin admin services (brpc_tpu.Builtin, brpc_tpu.Trace)
    # at start
    enable_builtin_services: bool = True
    # display name on the /status page
    server_info_name: str = ""
    # close connections with no read or write for this many seconds
    # (reference server.h idle_timeout_sec: a handler still computing
    # counts as idle, so size it above the slowest handler); -1 = never
    idle_timeout_s: int = -1
    # when >= 0: an extra TCP listener on this port (0 = ephemeral) that
    # serves the builtin admin pages only; tpu_std is refused there
    # (reference server.h internal_port keeps the admin pages off the
    # service address)
    internal_port: int = -1
    # per-request session data: factory() -> object, pooled across
    # requests (reference server.h session_local_data_factory; a handler
    # reads it with Controller.session_local_data())
    session_local_data_factory: Any = None
    # per-worker-thread data: factory() -> object (reference
    # thread_local_data_factory; read with Server.thread_local_data())
    thread_local_data_factory: Any = None
    # an ici:// server also opens the native front door (the C++ datapath
    # of csrc/ici_native.cpp); in-process channels prefer it for the
    # calls it can carry.  The Python listener stays open beside it.
    # False serves every call on the Python plane.  A server with an
    # authenticator serves on the Python plane only (the native door has
    # no verify hook)
    native_ici: bool = True
    # verifies every request's credential before user code runs
    # (policy/auth.py; tpu_std, http/h2 REST and gRPC): a failure is
    # ERPCAUTH, 401 or UNAUTHENTICATED
    auth: Any = None
    # http: url path -> "Service.Method" (reference restful.cpp), served
    # as JSON-RPC beside the /Service/Method routes
    restful_mappings: Dict[str, str] = field(default_factory=dict)
    # ssl.SSLContext: the TCP listener (and the internal port) speak TLS
    ssl_context: Any = None


def _connection_service_slot(svc) -> Optional[tuple]:
    """The server attribute a connection-level service fills and whether
    it takes a single owner, or None for a protobuf service.  Duck-typed,
    so the rpc layer imports no protocol module: a RedisService has
    ``dispatch`` and ``add_handler``, a ThriftService ``handle`` and
    ``add_method``, and the others name themselves in ``SERVICE_NAME``
    (nova, public_pbrpc and ubrpc ride on the nshead slot; an
    RtmpService makes each connection's streams)."""
    if hasattr(svc, "dispatch") and hasattr(svc, "add_handler"):
        return "redis_service", False
    if hasattr(svc, "handle") and hasattr(svc, "add_method"):
        return "thrift_service", False
    kind = getattr(svc, "SERVICE_NAME", None)
    if kind == "mongo" and hasattr(svc, "process"):
        return "_mongo_service", False
    if kind == "nshead" and hasattr(svc, "process_nshead_request"):
        return "_nshead_service", True
    if kind == "esp" and hasattr(svc, "process_esp_request"):
        return "_esp_service", True
    if kind == "rtmp" and hasattr(svc, "new_stream"):
        return "_rtmp_service", True
    return None


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Service] = {}
        self._methods: Dict[str, MethodDescriptor] = {}
        self._method_status: Dict[str, MethodStatus] = {}
        self._started = False
        self._listener = None    # IciListener, MemListener or Acceptor
        self._internal_acceptor = None   # the internal_port listener
        self._internal_port = -1
        self._reaper_thread: Optional[threading.Thread] = None
        self._native_ici = None          # native_plane.ServerBinding
        self.listen_endpoint = None
        self.messenger = InputMessenger(server=self)
        self._connections: List[Any] = []
        self._conn_lock = threading.Lock()
        self._server_concurrency = 0
        self._usercode_queued = 0        # queued/running backup-pool work
        self._conc_lock = threading.Lock()
        self._stopped = threading.Event()
        self._draining = False
        self._stop_lock = threading.Lock()
        self._stop_in_progress = False
        self._stopping_thread: Optional[threading.Thread] = None
        self.usercode_pool = None        # usercode_in_pthread backup pool
        self.admission = None            # AdmissionController when enabled
        # the last stop's drain: {"grace_s", "drained", "seconds"}, where
        # drained means in-flight work and plane transfers reached zero
        # inside the window
        self.last_drain: Optional[dict] = None
        self._builtin = None             # BuiltinDispatcher once started
        # methods with a device-side body, and the ranks this server
        # marked as serving them in the collective registry
        self._collective_regs: List[str] = []
        self._collective_served: List[int] = []
        self._isolated: Dict[str, tuple] = {}   # full -> (src, att_mode)
        self._session_data_pool: List[Any] = []
        self._session_data_lock = threading.Lock()
        self._thread_local = threading.local()
        # connection-level services (add_service): the protocol of each
        # claims a connection only while its slot is filled
        self.redis_service = None
        self.thrift_service = None
        self._mongo_service = None
        self._nshead_service = None
        self._esp_service = None
        self._rtmp_service = None

    # ---- registry -----------------------------------------------------
    def add_service(self, svc: Service) -> int:
        if self._started:
            raise RuntimeError("cannot add service after start")
        slot = _connection_service_slot(svc)
        if slot is not None:
            # a connection-level service (redis, thrift, mongo, nshead,
            # esp, rtmp) answers its protocol's frames itself; nshead, esp
            # and rtmp each take one owner
            attr, single = slot
            if single and getattr(self, attr) is not None:
                return errors.EINVAL
            setattr(self, attr, svc)
            return 0
        name = svc.service_name()
        if name in self._services:
            return errors.EINVAL
        self._services[name] = svc
        for md in svc.methods().values():
            self._methods[md.full_name] = md
            self._method_status[md.full_name] = MethodStatus(
                md.full_name, self._make_limiter(md.full_name))
        return 0

    def _make_limiter(self, full_name: str):
        mc = self.options.method_max_concurrency.get(full_name)
        kind = self.options.concurrency_limiter
        from ..policy import limiters
        if isinstance(mc, int) and mc > 0:
            return limiters.ConstantConcurrencyLimiter(mc)
        if mc == "auto" or kind == "auto":
            return limiters.AutoConcurrencyLimiter()
        if kind == "timeout":
            return limiters.TimeoutConcurrencyLimiter()
        if kind == "constant" and self.options.max_concurrency > 0:
            return limiters.ConstantConcurrencyLimiter(
                self.options.max_concurrency)
        return None

    def register_collective(self, method_full_name: str, handler,
                            merge: str = "gather", mapping: str = "shard",
                            takes_index: bool = False) -> None:
        """Attach a DEVICE-SIDE body to a served method: the compiled
        fan-out plane runs it on the rank's row when a Parallel or
        Partition call over ``ici://`` members lowers, with ``merge`` and
        ``mapping`` the contract the client's merger and mapper must
        match.  The wire method stays the body of the per-member RPC loop
        that any degrade completes on.  While this server serves
        ``ici://k``, rank k advertises the capability."""
        from ..channels import collective_fanout as _cf
        _cf.register_device_handler(method_full_name, handler,
                                    merge=merge, mapping=mapping,
                                    takes_index=takes_index)
        self._collective_regs.append(method_full_name)
        if self._started:
            self._serve_collective()

    def register_isolated(self, method_full_name: str, src: str,
                          att: str = "echo") -> None:
        """Serve a method from the usercode pool's isolation workers:
        ``src`` is handler SOURCE defining ``handle(payload: bytes) ->
        bytes``.  The request payload crosses as bytes and the return
        value is the serialized response payload; nothing else crosses
        (the share-nothing contract).  ``att`` says what happens to the
        request's attachment: "echo" returns it as the response's, "drop"
        releases it.  Needs ``usercode_in_pthread=True``; without
        isolation support the handler still runs, on the backup
        threads."""
        if att not in ("echo", "drop"):
            raise ValueError(f"unknown isolated att mode {att!r}")
        if self._started and not self.options.usercode_in_pthread:
            raise ValueError(
                "register_isolated requires usercode_in_pthread=True "
                "(isolated methods dispatch through the usercode pool)")
        self._isolated[method_full_name] = (src, att)
        if self.usercode_pool is not None:
            self.usercode_pool.register(method_full_name, src)

    def isolated_method(self, full_name: str) -> Optional[tuple]:
        """``(src, att_mode)`` of a method registered isolated, or None."""
        return self._isolated.get(full_name) if self._isolated else None

    def _serve_collective(self) -> None:
        ep = self.listen_endpoint
        if (self._collective_regs and ep is not None
                and ep.scheme == SCHEME_ICI
                and ep.device_id not in self._collective_served):
            # an epoch bump: a route degraded for a dead member re-probes
            from ..channels import collective_fanout as _cf
            _cf.registry().serve(ep.device_id)
            self._collective_served.append(ep.device_id)

    def find_method(self, full_name: str) -> Optional[MethodDescriptor]:
        return self._methods.get(full_name)

    def method_status(self, full_name: str) -> Optional[MethodStatus]:
        return self._method_status.get(full_name)

    def method_statuses(self) -> List[MethodStatus]:
        return list(self._method_status.values())

    def services(self) -> Dict[str, Service]:
        return dict(self._services)

    # ---- server-level concurrency (reference max_concurrency) ---------
    def on_request_in(self) -> bool:
        mc = self.options.max_concurrency
        with self._conc_lock:
            if mc > 0 and self._server_concurrency >= mc:
                return False
            self._server_concurrency += 1
            return True

    def on_request_out(self) -> None:
        with self._conc_lock:
            self._server_concurrency -= 1
        adm = self.admission
        if adm is not None:
            # a slot just freed: the admission queue's release pump
            adm.on_release()

    def on_request_rollback(self) -> None:
        """Undo on_request_in for a request that was never admitted (the
        method gate refused after the server gate passed).  Unlike
        on_request_out this neither pumps the admission queue nor records
        a service-rate sample: a rollback is not a completion, and
        pumping here would recurse (pump → gate → rollback → pump)."""
        with self._conc_lock:
            self._server_concurrency -= 1

    # usercode_in_pthread backlog accounting (InputMessenger): a request
    # QUEUED on the backup pool has not yet passed on_request_in, so the
    # drain gate needs its own counter to see it
    def on_usercode_queued(self) -> None:
        with self._conc_lock:
            self._usercode_queued += 1

    def on_usercode_done(self) -> None:
        with self._conc_lock:
            self._usercode_queued -= 1

    def inflight_requests(self) -> int:
        """Requests currently admitted or queued: the drain/join gate.
        One request can sit in several counters (the server's and its
        method's concurrency; the usercode backlog while it runs), so
        they combine with max(): zero exactly when everything finished."""
        with self._conc_lock:
            server_n = self._server_concurrency
            queued_n = self._usercode_queued
        method_n = sum(ms.concurrency
                       for ms in self._method_status.values())
        return max(server_n, method_n, queued_n)

    # ---- per-request / per-thread user data (server.h:126-150) --------
    def _get_session_data(self) -> Any:
        if self.options.session_local_data_factory is None:
            return None
        with self._session_data_lock:
            if self._session_data_pool:
                return self._session_data_pool.pop()
        return self.options.session_local_data_factory()

    def _return_session_data(self, data: Any) -> None:
        if data is None:
            return
        with self._session_data_lock:
            if len(self._session_data_pool) < 1024:
                self._session_data_pool.append(data)

    def thread_local_data(self) -> Any:
        """Data of the calling worker thread, made on first use by
        ``options.thread_local_data_factory`` (None without one)."""
        factory = self.options.thread_local_data_factory
        if factory is None:
            return None
        data = getattr(self._thread_local, "data", None)
        if data is None:
            data = self._thread_local.data = factory()
        return data

    # ---- lifecycle ----------------------------------------------------
    def start(self, addr: Any) -> int:
        """Listen on ``ici://k``, ``mem://name`` or ``host:port`` (also
        ``tcp://host:port``; port 0 binds an ephemeral one), a string or an
        EndPoint.  A stopped server may start again."""
        if self._started:
            return errors.EINVAL
        ep = parse_endpoint(addr) if isinstance(addr, str) else addr
        if ep.scheme not in (SCHEME_ICI, SCHEME_MEM, SCHEME_TCP):
            raise ValueError(f"cannot listen on scheme {ep.scheme}")
        if self.options.enable_builtin_services:
            from .builtin import register_builtin_services
            register_builtin_services(self)
        # a fresh event per run: stop() callers of the previous run hold
        # their own (set) event
        self._stopped = threading.Event()
        self._draining = False
        with self._conn_lock:
            self._connections = []
        if self._isolated and not self.options.usercode_in_pthread:
            # without the pool an isolated method has no dispatch route,
            # and its callers would get a misleading ENOMETHOD
            raise ValueError(
                "register_isolated requires usercode_in_pthread=True "
                "(isolated methods dispatch through the usercode pool)")
        if self.options.usercode_in_pthread and self.usercode_pool is None:
            from .usercode_pool import UsercodePool
            self.usercode_pool = UsercodePool(
                kind=self.options.usercode_pool_kind,
                workers=max(self.options.usercode_backup_threads, 1))
            for full, (src, _att) in self._isolated.items():
                self.usercode_pool.register(full, src)
        if self.options.admission:
            from .admission import AdmissionController, AdmissionOptions
            if self.admission is None:
                aopts = self.options.admission if isinstance(
                    self.options.admission, AdmissionOptions) else None
                self.admission = AdmissionController(self, aopts)
            else:
                self.admission.reset()   # restart lifts the stop refusal
        if ep.scheme == SCHEME_ICI:
            from ..ici.transport import ici_listen
            self._listener = ici_listen(ep.device_id, self._on_accept)
            if self.options.native_ici and self.options.auth is None:
                from ..ici import native_plane
                try:
                    self._native_ici = native_plane.ServerBinding(
                        self, ep.device_id)
                except Exception as e:
                    # the native door is an accelerator, not a
                    # requirement: the Python plane serves every call
                    log.warning("native ici plane unavailable (%s); "
                                "Python datapath only", e)
        elif ep.scheme == SCHEME_TCP:
            from .tcp_transport import Acceptor
            acceptor = Acceptor(self._on_accept,
                                ssl_context=self.options.ssl_context)
            port = acceptor.start(ep.host or "0.0.0.0", ep.port)
            self._listener = acceptor
            ep = EndPoint(scheme=SCHEME_TCP, host=ep.host or "0.0.0.0",
                          port=port)
        else:
            from .mem_transport import mem_listen
            self._listener = mem_listen(ep.host, self._on_accept)
            # the loopback plane: in-process channels dispatch straight
            # into this server's method table (loopback.py)
            from . import loopback
            loopback.register_server(ep.host, self)
        self.listen_endpoint = ep
        try:
            if self.options.internal_port >= 0:
                from .tcp_transport import Acceptor
                # the main listener's bind host when it is TCP; a mem://
                # or ici:// server keeps its admin port on loopback, never
                # a surprise 0.0.0.0 listener
                host = ep.host if ep.scheme == SCHEME_TCP and ep.host \
                    else "127.0.0.1"
                self._internal_acceptor = Acceptor(
                    self._on_accept_internal,
                    ssl_context=self.options.ssl_context)
                self._internal_port = self._internal_acceptor.start(
                    host, self.options.internal_port)
            if self.options.idle_timeout_s > 0:
                self._start_idle_reaper()
        except Exception:
            # a half-started server must not leak its live listeners: a
            # retry of start() would otherwise double-bind
            self._close_listener()
            raise
        self._started = True
        from . import lameduck
        lameduck.clear_local_draining(ep)   # restart lifts the drain mark
        # pod membership: a joined pod advertises the serving rank (epoch
        # bump); a no-op for a non-ici server or with no pod
        from ..ici import pod as _pod
        _pod.on_server_started(ep)
        self._serve_collective()
        if self.options.graceful_quit_on_sigterm:
            if not lameduck.enable_graceful_quit(self):
                log.warning(
                    "graceful_quit_on_sigterm requested but the SIGTERM "
                    "hook could not be installed (server started off "
                    "the main thread): TERM will not drain this server")
        log.info("Server started on %s with %d services", ep,
                 len(self._services))
        # version ping, off unless the trackme_server flag is set
        # (reference server.cpp StartInternal → trackme.cpp:36)
        from .trackme import start_trackme
        start_trackme(str(ep))
        return 0

    def _on_accept(self, sock) -> None:
        sock.messenger = self.messenger
        sock.usercode_inline = self.options.usercode_inline
        with self._conn_lock:
            self._connections = [s for s in self._connections if not s.failed]
            self._connections.append(sock)

    def _on_accept_internal(self, sock) -> None:
        sock.internal_only = True      # admin pages only (input_messenger)
        self._on_accept(sock)

    @property
    def listen_port(self) -> int:
        """The bound TCP port of a ``host:port`` server, else -1."""
        ep = self.listen_endpoint
        return ep.port if ep is not None and ep.scheme == SCHEME_TCP else -1

    @property
    def internal_port(self) -> int:
        """The bound admin port (``ServerOptions.internal_port``), else
        -1."""
        return self._internal_port

    def _start_idle_reaper(self) -> None:
        # this run's stop event: a reaper of an earlier run sees its own
        # (set) event and exits even when a new run is already up
        stopped = self._stopped
        idle_s = self.options.idle_timeout_s

        def reap() -> None:
            period = max(0.5, idle_s / 2.0)
            while not stopped.wait(period):
                cutoff = _time.monotonic() - idle_s
                with self._conn_lock:
                    conns = list(self._connections)
                for s in conns:
                    if s.last_active <= cutoff:
                        s.set_failed(errors.ECLOSE, f"idle > {idle_s}s")

        t = threading.Thread(target=reap, name="idle_reaper", daemon=True)
        self._reaper_thread = t
        t.start()

    def is_running(self) -> bool:
        return self._started and not self._stopped.is_set()

    def is_draining(self) -> bool:
        """Lame-duck state: new requests bounce with retryable ELOGOFF
        while in-flight work completes."""
        return self._draining

    def _close_listener(self) -> None:
        native, self._native_ici = self._native_ici, None
        if native is not None:
            native.stop()
        internal, self._internal_acceptor = self._internal_acceptor, None
        if internal is not None:
            internal.stop()
            self._internal_port = -1
        listener, self._listener = self._listener, None
        if listener is None:
            return
        if self.listen_endpoint.scheme == SCHEME_TCP:
            listener.stop()
        elif self.listen_endpoint.scheme == SCHEME_ICI:
            from ..ici.transport import ici_unlisten
            ici_unlisten(listener.device_id)
        else:
            from .mem_transport import mem_unlisten
            from . import loopback
            mem_unlisten(listener.name)
            loopback.unregister_server(listener.name, self)

    def stop(self, grace_s: Optional[float] = None) -> int:
        """Stop the server.  ``grace_s > 0`` (default: ``ServerOptions.
        graceful_shutdown_s``) drains first — lame-duck mode (reference
        Server::Stop(closewait_ms)):

          1. the server flips to *draining*: the admission queue bounces
             its waiting entries with ELOGOFF, ici:// sockets send
             GOODBYE so peers pull the endpoint from their balancers,
             and NEW requests bounce with retryable ELOGOFF.  The
             listener, the native door and the loopback name stay open
             through the window, marked draining, so a caller that
             reconnects gets the same bounce (all are in-process front
             doors);
          2. in-flight handlers, queued usercode, streams open on the
             server's connections, responses still queued on them and
             device-plane transfers complete inside the grace window (a
             transfer counts until the completion poller saw its copy's
             event, or, sent to another process, until its PULLED);
          3. only stragglers past the window are failed: streams get an
             orderly CLOSE (after every frame they wrote) instead of the
             reset a failed connection would mean, connections fail with
             ELOGOFF, and sends posted before the drain and still
             unmatched are failed, so their source pins release.

        A stop from a thread the drain itself runs returns at once; a
        second concurrent stop waits for the first."""
        if grace_s is None:
            grace_s = self.options.graceful_shutdown_s or 0.0
        with self._stop_lock:
            if not self._started:
                return 0
            if self._stop_in_progress:
                stopping, stopped = self._stopping_thread, self._stopped
            else:
                self._stop_in_progress = True
                self._stopping_thread = threading.current_thread()
                stopping = None
        if stopping is not None:
            if stopping is not threading.current_thread():
                stopped.wait()
            return 0
        try:
            self._stop_locked(grace_s)
        finally:
            with self._stop_lock:
                self._stop_in_progress = False
                self._stopping_thread = None
            if not self._stopped.is_set():
                # _stop_locked raised midway: the error propagates to this
                # caller, but waiting stop() callers and join() unblock
                self._draining = False
                self._started = False
                self._stopped.set()
        return 0

    def _stop_locked(self, grace_s: float) -> None:
        from . import lameduck
        ep = self.listen_endpoint
        drained = True
        drain_start_ns = 0
        if grace_s > 0:
            self._draining = True
            drain_start_ns = _time.monotonic_ns()
            lameduck.mark_local_draining(ep)
            # the pod's drain mark: pod:// drops the rank even for
            # processes holding no socket to this one
            from ..ici import pod as _pod
            _pod.on_server_draining(ep)
            if self._listener is not None:
                self._listener.draining = True
            if self.admission is not None:
                # queued-not-started entries bounce at drain start:
                # callers fail over now instead of waiting out the window
                self.admission.fail_all(errors.ELOGOFF,
                                        "server is draining (lame duck)")
            self._send_goodbyes()
            drained = self._drain_until(_time.monotonic() + grace_s)
            self.last_drain = {
                "grace_s": grace_s, "drained": drained,
                "seconds": (_time.monotonic_ns() - drain_start_ns) / 1e9}
        if self.admission is not None:
            self.admission.fail_all(errors.ELOGOFF, "server stopping")
        self._close_listener()
        with self._conn_lock:
            conns, self._connections = self._connections, []
        if grace_s > 0:
            self._close_server_streams(conns)
            if not drained:
                self._fail_pending_device_transfers(drain_start_ns)
        # loopback stragglers (past the grace window, or any in flight on
        # an immediate stop) fail as the wire connections below do: claimed
        # with retryable ELOGOFF, the running handler's late done() dropped
        from . import loopback
        loopback.fail_inflight(self, errors.ELOGOFF, "server stopping")
        for s in conns:
            if getattr(s, "_h2_conn", None) is not None:
                # h2: GOAWAY first, naming the last stream this server
                # took, so the peer fails the rest retryably at once
                from ..policy.grpc import send_goaway
                send_goaway(s)
            s.set_failed(errors.ELOGOFF, "server stopping")
        pool, self.usercode_pool = self.usercode_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        self._stopped.set()
        reaper, self._reaper_thread = self._reaper_thread, None
        if reaper is not None and reaper is not threading.current_thread():
            reaper.join(2.0)
        self._started = False
        self._draining = False
        lameduck.clear_local_draining(ep)
        from ..ici import pod as _pod
        _pod.on_server_stopped(ep)
        if self._collective_served:
            from ..channels import collective_fanout as _cf
            served, self._collective_served = self._collective_served, []
            for dev in served:
                _cf.registry().withdraw(dev)

    # ---- drain machinery ----------------------------------------------
    def _send_goodbyes(self) -> None:
        """Proactive lame-duck notification on every connection whose
        transport supports it (ici:// sockets): peers pull this endpoint
        from their balancers NOW instead of at a health-check probe."""
        with self._conn_lock:
            conns = list(self._connections)
        for s in conns:
            fn = getattr(s, "send_goodbye", None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    log.error("GOODBYE to %s failed", s.remote_side,
                              exc_info=True)

    def _drain_until(self, deadline: float) -> bool:
        """Block until in-flight handlers, queued usercode, open server
        streams, responses still queued on a connection and device-plane
        transfers are all done, or the deadline passes.  True when fully
        drained.  (A response leaves its connection's queue only after
        its device payload was posted, so checking the queues before the
        plane misses neither.)"""
        while True:
            if (self.inflight_requests() == 0
                    and not self._open_server_streams()
                    and not self._unwritten_connections()
                    and self._device_plane_active() == 0):
                return True
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(0.005)

    def _unwritten_connections(self) -> bool:
        """A live connection still holds a queued or half-written
        response: its handler finished, but closing now would fail an
        answered call."""
        with self._conn_lock:
            conns = [s for s in self._connections if not s.failed]
        return any(s._write_queue or s._writing for s in conns)

    def _open_server_streams(self) -> List[Any]:
        """Streams not yet closed that ride this server's connections."""
        from .stream import live_streams
        with self._conn_lock:
            conns = {id(s) for s in self._connections if not s.failed}
        return [st for st in live_streams()
                if not st.closed and st.socket is not None
                and id(st.socket) in conns]

    @staticmethod
    def _close_server_streams(conns: List[Any]) -> None:
        """Past the grace window: an orderly CLOSE on every stream still
        open on a live connection, written before the connection fails."""
        from .stream import live_streams
        conn_ids = {id(s) for s in conns if not s.failed}
        for st in live_streams():
            if not st.closed and st.socket is not None \
                    and id(st.socket) in conn_ids:
                st.close()

    @staticmethod
    def _device_plane_active() -> int:
        """Posted-but-incomplete device-plane transfers in this process; 0
        when the plane was never instantiated."""
        from ..ici.device_plane import DevicePlane
        plane = DevicePlane._instance
        return plane.active_transfers() if plane is not None else 0

    @staticmethod
    def _fail_pending_device_transfers(posted_before_ns: int) -> None:
        """Grace expired with transfers still posted: fail the ones that
        were posted before the drain began (and so sat unmatched through
        the whole window), so their completions fire and their source
        pins release — a lame-duck stop may strand a straggler RPC, never
        a pin in device memory.  Newer posts belong to other traffic."""
        from ..ici.device_plane import DevicePlane
        plane = DevicePlane._instance
        if plane is not None:
            plane.fail_pending("server stopped before rendezvous "
                               "(lame-duck grace expired)",
                               posted_before_ns=posted_before_ns)

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until the server has stopped AND its in-flight handlers
        have finished (reference Server::Join runs after Stop's
        close-wait)."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        if not self._stopped.wait(timeout):
            return
        while self.inflight_requests() > 0:
            if deadline is not None and _time.monotonic() >= deadline:
                return
            _time.sleep(0.002)

    def connections(self) -> List[Any]:
        with self._conn_lock:
            return [s for s in self._connections if not s.failed]
