"""Channel: the client stub.

Reference: src/brpc/channel.{h,cpp} (Init :236-393, CallMethod :407-592) and
Controller::IssueRPC (controller.cpp:985-1144).  A channel targets one
``ici://k``, ``mem://name`` or ``host:port`` endpoint, or a naming url (``list://``,
``file://``, ``mesh://``) whose members a load balancer picks from per
try, over ``ChannelOptions.protocol`` (tpu_std by default, or http or
grpc); per-call state lives in the Controller.  ``init`` takes
the reference's signature, ``init(target, lb_name="", options=None)``.  A
call made inside a handler inherits the inbound request's context
(:mod:`.request_context`).  Every call's outcome feeds the endpoint's
circuit breaker; while the breaker isolates the endpoint a call fails fast
instead of stampeding a recovering peer (a balanced channel excludes it
from its balancer instead), and the health checker's probe lifts the
isolation (:mod:`.circuit_breaker`, :mod:`.health_check`).  A streaming
call (``cntl.stream_creator`` set) rides one connection: it takes no
retry, and a balanced channel refuses it.

The options pick the connection (``connection_type``: the shared single
one, a pooled one a call holds alone, or a short one closed after the
call), hedging (``backup_request_ms``, ``retry_on_timeout``), the spacing
of connection-class retries (``retry_backoff_ms``) and a filter of the
naming service's members (``ns_filter``).  A Controller's own
``backup_request_ms``, ``retry_on_timeout`` and ``retry_backoff_ms`` win
over the channel's.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from . import errors
from . import loopback as _loopback
from . import request_context as _reqctx
from .circuit_breaker import BreakerRegistry
from .protocol import (CONNECTION_TYPE_POOLED, CONNECTION_TYPE_SHORT,
                       CONNECTION_TYPE_SINGLE)
from ..butil.endpoint import (EndPoint, parse_endpoint, SCHEME_ICI,
                               SCHEME_MEM, SCHEME_TCP)
from .controller import Controller
from .input_messenger import InputMessenger
from .protocol import find_protocol
from .socket_map import SocketMap
from .span import (end_client_span, maybe_start_client_span,
                   set_client_span_local, _rpcz_flag as _rpcz)
from ..bthread import scheduler as _sched


_CONNECTION_TYPES = {"single": CONNECTION_TYPE_SINGLE,
                     "pooled": CONNECTION_TYPE_POOLED,
                     "short": CONNECTION_TYPE_SHORT}


@dataclass
class ChannelOptions:
    # the wire protocol: "tpu_std", "http" (JSON over HTTP/1.1) or "grpc"
    # (h2); only tpu_std takes the native door and the loopback plane
    protocol: str = "tpu_std"
    # Authenticator (policy/auth.py): fills each call's auth_token when
    # the call set none
    auth: Any = None
    # "" = single; an explicit value must be one the protocol supports
    connection_type: str = ""           # "" | single | pooled | short
    timeout_ms: int = 1000
    # a TCP connect's limit: < 0 waits as long as the kernel does, 0 takes
    # the default (1 s)
    connect_timeout_ms: int = 1000
    max_retry: int = 3
    # hedging: a backup try when no answer came within this many ms; the
    # first answer wins (0 = off)
    backup_request_ms: int = 0
    # opt-in hedging on silence: timeout_ms is split evenly over the
    # max_retry + 1 tries, and a try whose share elapses with no reply
    # gets a fresh try beside it (a dropped request is recovered).  Off
    # by default: a hedge may run a non-idempotent request twice, as a
    # backup request may.  Ignored when backup_request_ms is set
    retry_on_timeout: bool = False
    # base delay of a retry after a connection-class failure, doubling per
    # retry with seeded jitter (0 = retry at once): spaced retries let a
    # call issued during an outage live until the health check revives
    # the peer
    retry_backoff_ms: int = 0
    # membership filter of a naming url's servers: fn(ServerEntry) -> bool
    ns_filter: Optional[Callable[[Any], bool]] = None
    # admission defaults for every call on the channel: a call's own
    # Controller values win, then the inbound request's, then these
    priority: Optional[int] = None
    tenant: str = ""
    # the rank this channel's caller lives on, for ici:// targets on the
    # native plane: response device refs relocate toward it.  None takes
    # the target's neighbour, (remote + 1) % mesh.size; a caller on the
    # server's own rank passes that rank for the pure ref-pass round trip
    ici_local_device: Optional[int] = None


# the loopback screen's modules, resolved at first call (the policy <-> rpc
# import cycle)
_loopback_screen = None


def _loopback_screen_modules():
    global _loopback_screen
    if _loopback_screen is None:
        from . import fault_injection as _fi
        from . import rpc_dump as _dump
        from ..policy.tpu_std import _stage_flag
        _loopback_screen = (_fi, _dump, _stage_flag)
    return _loopback_screen


class Channel:
    def __init__(self):
        self.options = ChannelOptions()
        self._endpoint: Optional[EndPoint] = None
        self._lb = None                  # balancer over a naming url
        self._ns_thread = None
        self._ns_watcher = None          # the balancer, or its filter
        self._protocol = None
        self.messenger = InputMessenger(server=None)
        self._native_ici = None          # native_plane.ChannelBinding
        self._native_ici_lock = threading.Lock()
        self._loopback_name: Optional[str] = None
        self._loopback_breaker = None

    # ---- init ---------------------------------------------------------
    def init(self, target: Any, lb_name: str = "",
             options: Optional[ChannelOptions] = None) -> int:
        """``target`` is an endpoint (``ici://k``, ``mem://name`` or an
        EndPoint) or a naming url, whose members ``lb_name``'s balancer
        (round robin when empty) picks from."""
        if options is not None:
            self.options = options
        self._protocol = find_protocol(self.options.protocol)
        if self._protocol is None:
            raise ValueError(f"unknown protocol {self.options.protocol!r}"
                             " (protocols register on importing "
                             "brpc_tpu_torch.policy)")
        ctype = self.options.connection_type
        if ctype and ctype not in _CONNECTION_TYPES:
            raise ValueError(f"unknown connection_type {ctype!r}")
        if ctype and not (self._protocol.supported_connection_type
                          & _CONNECTION_TYPES[ctype]):
            # the reference fails Channel::Init on an unsupported explicit
            # type rather than changing it
            raise ValueError(f"protocol {self._protocol.name!r} does not "
                             f"support connection_type={ctype!r}")
        from ..policy.naming import is_naming_url
        if isinstance(target, str) and is_naming_url(target):
            from ..policy.load_balancers import create_load_balancer
            from ..policy.naming import get_naming_service_thread
            self._lb = create_load_balancer(lb_name or "rr")
            self._ns_thread = get_naming_service_thread(target)
            self._ns_watcher = self._lb
            if self.options.ns_filter is not None:
                self._ns_watcher = _FilteredWatcher(self._lb,
                                                    self.options.ns_filter)
            self._ns_thread.add_watcher(self._ns_watcher)
            return 0
        ep = parse_endpoint(target) if isinstance(target, str) else target
        if ep.scheme not in (SCHEME_ICI, SCHEME_MEM, SCHEME_TCP):
            raise ValueError(f"unsupported scheme {ep.scheme}")
        self._endpoint = ep
        if (ep.scheme == SCHEME_MEM and self.options.backup_request_ms <= 0
                and self.options.protocol == "tpu_std"
                and self.options.auth is None):
            # the loopback plane's channel-level screen (the per-call ones
            # are in call_method): unary tpu_std to an in-process mem://
            # server, no authenticator, no hedging.  The breaker gates it
            # too: an isolated endpoint fails fast in process (loopback
            # calls themselves never trip or reset a breaker)
            self._loopback_name = ep.host
            self._loopback_breaker = BreakerRegistry.instance().breaker(ep)
        return 0

    # ---- calls ----------------------------------------------------------
    def call_method(self, method_full_name: str, cntl: Controller,
                    request: Any, response_cls: Any = None,
                    done: Optional[Callable[[Controller], None]] = None):
        """Sync when done is None (returns the response); async otherwise."""
        # the fused native path: a cached in-process ici:// binding serves
        # sync calls in one place (context, screens, call, error tails).
        # What it cannot carry (oversize frames, hedging, a dead
        # connection's one re-route) falls through to the body below
        nch0 = self._native_ici
        skip_native = False
        if (nch0 is not None and done is None and nch0._fused
                and cntl.stream_creator is None
                and not cntl.compress_type and not cntl.auth_token):
            result = nch0.call_fused(method_full_name, cntl, request,
                                     response_cls, self)
            if result is not nch0.FUSED_FALLTHROUGH:
                return result
            skip_native = True
        if cntl.stream_creator is not None:
            # the stream is bound to the connection its handshake rode: a
            # retry would leave an accepted stream orphaned on the first
            if self._lb is not None:
                cntl.set_failed(errors.EINVAL, "a streaming call needs a "
                                "channel to one endpoint, not a balancer")
                if done is not None:
                    done(cntl)
                return None
            cntl.max_retry = 0
        ctx = _reqctx.current()
        if ctx is not None:
            # inside a handler: inherit what the call did not set, and cap
            # the timeout at the budget the inbound request has left
            if cntl.priority is None and ctx.priority is not None:
                cntl.priority = ctx.priority
            if not cntl.tenant and ctx.tenant:
                cntl.tenant = ctx.tenant
            residual = ctx.residual_deadline_ms()
            if residual is not None:
                if residual <= 0:
                    cntl.set_failed(errors.ERPCTIMEDOUT,
                                    "inherited deadline budget spent "
                                    "before call")
                    if done is not None:
                        done(cntl)
                    return None
                base = (cntl.timeout_ms if cntl.timeout_ms is not None
                        else self.options.timeout_ms)
                if base is None or base <= 0 or base > residual:
                    cntl.timeout_ms = max(int(residual), 1)
        if cntl.priority is None and self.options.priority is not None:
            cntl.priority = self.options.priority
        if not cntl.tenant and self.options.tenant:
            cntl.tenant = self.options.tenant
        # the native plane: when the target rank has a native listener in
        # this process, the unary hot path (framing, window, dispatch,
        # correlation) runs in the C++ core, and Python only relocates
        # device refs.  Streaming, hedging and frames too large for the
        # native window take the Python plane
        nch = None
        if not skip_native:
            nch = self._native_ici
            if nch is None:
                nch = self._native_ici_binding(cntl)
            elif (cntl.stream_creator is not None or cntl.compress_type
                  or cntl.auth_token):
                # the per-call screens; the channel's (protocol,
                # authenticator) were read when the binding was made
                nch = None
        if nch is not None and not self._fast_call_fits(nch, cntl, request):
            nch = None
        if nch is not None:
            if cntl.timeout_ms is None:
                cntl.timeout_ms = self.options.timeout_ms
            if done is None:
                result = self._native_ici_call(nch, method_full_name, cntl,
                                               request, response_cls)
                result = self._native_shed_retry(nch, method_full_name,
                                                 cntl, request,
                                                 response_cls, result)
                if not self._native_ici_fallback(cntl):
                    if cntl.span is not None:
                        end_client_span(cntl)
                    return result
            else:
                def _run():
                    try:
                        self._native_ici_call(nch, method_full_name, cntl,
                                              request, response_cls)
                    except Exception as e:   # done() always fires
                        if not cntl.failed():
                            cntl.set_failed(errors.EINTERNAL,
                                            f"{type(e).__name__}: {e}")
                        cntl._ended.set()
                        done(cntl)
                        return
                    if self._native_ici_fallback(cntl):
                        # a dead native connection or an oversize frame:
                        # the Python plane carries the call
                        self.call_method(method_full_name, cntl, request,
                                         response_cls, done=done)
                    else:
                        if cntl.span is not None:
                            end_client_span(cntl)
                        cntl._ended.set()        # Controller.join returns
                        done(cntl)

                # a thread of its own, not a scheduler worker: the call
                # parks in the core until its answer
                from ..ici import native_plane
                native_plane.run_async(_run)
                return None
        # the mem:// loopback plane (loopback.py).  Per-call screens: what
        # the wire plane implements and loopback does not (streaming,
        # compression, a credential, fault injection, rpc_dump sampling)
        # and what exists to observe the wire plane (rpcz-sampled calls,
        # the stage-metrics mode) take the wire
        lb_name = self._loopback_name
        if (lb_name is not None and cntl.stream_creator is None
                and not cntl.compress_type and not cntl.auth_token
                and _loopback.enabled()):
            _fi, _dump, _stage_flag = _loopback_screen_modules()
            if cntl.span is None:
                maybe_start_client_span(cntl, method_full_name)
            srv = _loopback.server_for(lb_name)
            # a method served by the isolation workers has no method
            # descriptor: it takes the wire path, which dispatches it
            # a server with an authenticator verifies on the wire
            if (srv is not None and cntl.span is None
                    and srv.options.auth is None
                    and srv.isolated_method(method_full_name) is None
                    and not self._loopback_breaker.is_isolated()
                    and _stage_flag.value != "on"
                    and _fi.active() is None
                    and not _dump.dump_enabled()):
                if cntl.timeout_ms is None:
                    cntl.timeout_ms = self.options.timeout_ms
                return _loopback.call(srv, method_full_name, cntl,
                                      request, response_cls, done)
        # a Controller reused after a loopback call joins this call's id
        cntl.__dict__.pop("_loopback_state", None)
        if self.options.auth is not None and not cntl.auth_token:
            cntl.auth_token = self.options.auth.generate_credential(cntl)
        payload = self._protocol.serialize_request(request, cntl)
        if _rpcz.value and cntl.span is None:
            maybe_start_client_span(cntl, method_full_name)
        cntl._start_call(self, method_full_name, payload, response_cls, done)
        if done is None:
            timeout = ((cntl.timeout_ms or 0) / 1000.0 + 35.0)
            cntl.join(timeout)
            return cntl.response
        return None

    # ---- the native plane ---------------------------------------------
    def _fast_call_fits(self, nch, cntl: Controller, request) -> bool:
        """The native plane's per-call screen: the frame (payload,
        attachment and 64 KiB of headroom) fits the native send window,
        and the channel does not hedge with backup requests."""
        try:                            # a non-proto request has no size
            req_sz = request.ByteSize()
        except Exception:
            req_sz = 0
        att = cntl._peek_request_attachment()
        att_len = len(att) if att is not None else 0
        return (att_len + req_sz + 65536 <= nch.window_bytes
                and self.options.backup_request_ms <= 0)

    def inline_fast_call_ok(self, cntl: Controller, request,
                            method_full_name: str) -> bool:
        """True when this call would take the native plane and the
        listener answers it inline on the caller's thread, so issuing it
        synchronously from a fan-out loop costs nothing over a tasklet.
        Mirrors call_method's routing screens."""
        nch = self._native_ici
        if nch is None or cntl.stream_creator is not None:
            return False
        if not self._fast_call_fits(nch, cntl, request):
            return False
        from ..ici import native_plane
        return native_plane.listener_dispatch_inline(
            nch.remote_dev, method_full_name) is True

    def _native_ici_call(self, nch, method_full_name: str,
                         cntl: Controller, request, response_cls):
        """One native call with the client span.  No retry loop: the one
        retryable error of an in-process transport is EFAILEDSOCKET (the
        connection died with its server), which _native_ici_fallback
        re-routes; every other failure would repeat on a retry."""
        if cntl.span is None:
            maybe_start_client_span(cntl, method_full_name)
        return nch.call(method_full_name, cntl, request, response_cls)

    def _native_shed_retry(self, nch, method_full_name: str,
                           cntl: Controller, request, response_cls,
                           result):
        """A shed's retry_after_ms on the native plane (sync calls): sleep
        the hint (plus jitter above it, never below) and reissue, within
        the retry budget and one overall deadline.  The wire plane does
        the same through the Controller's retry machinery."""
        from .admission import shed_backoff_s
        max_retry = cntl.max_retry if cntl.max_retry is not None \
            else self.options.max_retry
        attempt = 0
        orig_tms = cntl.timeout_ms
        # the budget started with the first attempt
        t0 = _time.monotonic() - (cntl.latency_us / 1e6)
        try:
            while (cntl.error_code_ == errors.ELIMIT
                   and cntl.retry_after_ms > 0 and attempt < max_retry):
                attempt += 1
                delay_s = shed_backoff_s(cntl.retry_after_ms)
                if orig_tms and orig_tms > 0:
                    remaining = orig_tms / 1000.0 \
                        - (_time.monotonic() - t0)
                    if delay_s >= remaining:
                        cntl.set_failed(
                            errors.ERPCTIMEDOUT,
                            f"reached timeout={orig_tms}ms backing "
                            "off from admission shed")
                        return None
                _sched.note_worker_blocked()
                try:
                    _time.sleep(delay_s)
                finally:
                    _sched.note_worker_unblocked()
                cntl.error_code_ = 0
                cntl.error_text_ = ""
                cntl.retry_after_ms = 0
                cntl.retried_count += 1
                if orig_tms and orig_tms > 0:
                    # the reissue gets what is left of the budget
                    left_ms = int((orig_tms / 1000.0
                                   - (_time.monotonic() - t0)) * 1000)
                    if left_ms <= 0:
                        cntl.set_failed(errors.ERPCTIMEDOUT,
                                        f"reached timeout={orig_tms}ms")
                        return None
                    cntl.timeout_ms = left_ms
                result = self._native_ici_call(nch, method_full_name,
                                               cntl, request, response_cls)
        finally:
            cntl.timeout_ms = orig_tms
        return result

    def _native_ici_fallback(self, cntl: Controller) -> bool:
        """After a native failure, whether the call re-routes through the
        Python plane (once per call): on EFAILEDSOCKET (the cached
        connection died with its server; the cache is dropped) and on the
        oversize fast-fail (the Python plane drains the frame through
        its window)."""
        code = cntl.error_code_
        if code == errors.EFAILEDSOCKET:
            drop_cache = True
        elif code == errors.EOVERCROWDED and \
                cntl.error_text_.startswith("frame larger"):
            drop_cache = False
        else:
            return False
        if cntl.__dict__.get("_ici_rerouted"):
            return False               # one re-route per call
        cntl._ici_rerouted = True
        if drop_cache:
            with self._native_ici_lock:
                stale, self._native_ici = self._native_ici, None
            if stale is not None:
                stale.close()
        cntl.error_code_ = 0
        cntl.error_text_ = ""
        return True

    def _native_ici_binding(self, cntl: Controller):
        """The native in-process connection to the target rank, or None
        (the Python plane): no native listener, a balanced channel, a
        streaming call."""
        ep = self._endpoint
        if (ep is None or ep.scheme != SCHEME_ICI
                or self.options.protocol != "tpu_std"
                or self.options.auth is not None
                or cntl.stream_creator is not None
                or cntl.compress_type or cntl.auth_token):
            return None
        cached = self._native_ici
        if cached is not None:
            return cached
        try:
            from ..ici import native_plane
            if not (native_plane.available()
                    and native_plane.has_listener(ep.device_id)):
                return None
            with self._native_ici_lock:
                if self._native_ici is None:
                    self._native_ici = native_plane.ChannelBinding(
                        ep.device_id,
                        local_dev=self.options.ici_local_device)
                return self._native_ici
        except Exception:
            return None

    # IssueRPC: runs once per try -----------------------------------------
    def _issue_rpc(self, cntl: Controller) -> None:
        if self._lb is not None:
            ep = self._lb.select_server(cntl)
            if ep is None:
                raise ConnectionError("no available server")
        else:
            ep = self._endpoint
        cntl._selected_endpoint = ep
        if self._lb is None and \
                BreakerRegistry.instance().breaker(ep).is_isolated():
            raise ConnectionError(f"{ep} isolated by circuit breaker")
        sock = self._select_socket(cntl, ep)
        cntl.remote_side = sock.remote_side
        # a socket that fails EINTERNAL (a refused device payload) names
        # the refusal; the call's text is that reason (Controller)
        cntl._try_socket = sock
        # a connection-stateful protocol (h2) packs on the socket itself
        cntl._pack_socket = sock
        cid = cntl.current_cid()
        proto = self._protocol
        if proto.pipelined:
            # the response takes the oldest id: queue and write under one
            # lock, so the ids stay in the order the requests left
            with sock._pipeline_write_lock:
                packet = proto.pack_request(
                    cntl._request_buf, cid, cntl, cntl._method_full_name)
                sock.push_pipelined_context(cid)
                cntl._pipelined.append((sock, cid))
                rc = sock.write(packet, notify_cid=cid)
            if rc != 0:
                raise ConnectionError(f"write failed: {rc}")
            return
        packet = proto.pack_request(
            cntl._request_buf, cid, cntl, cntl._method_full_name)
        span = cntl.span
        if span is None:
            rc = sock.write(packet, notify_cid=cid)
        else:
            # the client span is the active one while this thread writes:
            # the device plane's events of the request land in its trace.
            # Decided before the write: an inline completion ends the call
            # (and clears cntl.span) inside it
            span.annotate(f"issue try={cntl.current_try} to "
                          f"{sock.remote_side}")
            prev = _sched.local_get("rpcz_client_span")
            set_client_span_local(span)
            try:
                rc = sock.write(packet, notify_cid=cid)
            finally:
                set_client_span_local(prev)
        if rc != 0:
            raise ConnectionError(f"write failed: {rc}")

    def _select_socket(self, cntl: Controller, ep: EndPoint):
        """The try's connection by ``connection_type``: a pooled or short
        one is remembered on the Controller, to be returned or closed when
        the call ends (every try's: a hedged try may still answer)."""
        smap = SocketMap.instance()
        ctype = self.options.connection_type
        cto_ms = self.options.connect_timeout_ms
        cto = None if cto_ms < 0 else (cto_ms or 1000) / 1000.0
        if ctype == "pooled":
            sock = smap.get_pooled_socket(ep, self.messenger,
                                          group=self._protocol.name,
                                          connect_timeout=cto)
            cntl._pooled_sockets.append((ep, sock))
        elif ctype == "short":
            sock = smap.get_short_socket(ep, self.messenger,
                                         connect_timeout=cto)
            cntl._short_sockets.append(sock)
        else:
            sock = smap.get_socket(ep, self.messenger,
                                   group=self._protocol.name,
                                   connect_timeout=cto)
        return sock

    def _on_call_end(self, cntl: Controller) -> None:
        """Return the call's pooled connections and close its short ones.
        Then feed the endpoint's breaker; a trip hands the endpoint to the
        health checker, whose successful probe resets the breaker.  An
        admission shed (ELIMIT with a retry_after_ms hint) is a healthy
        server saying "not now": it counts as a success here, or an
        overload would isolate the server still serving its protected
        band."""
        d = cntl.__dict__
        if cntl.failed():
            exclusive = {id(s) for _ep, s in d.get("_pooled_sockets", ())}
            exclusive.update(id(s) for s in d.get("_short_sockets", ()))
            for sock, ctx in d.get("_pipelined", ()):
                # a failed call whose context still waits on a connection
                # only it uses: the late response would answer the next
                # call on it, so the connection goes
                if id(sock) in exclusive:
                    with sock._pipeline_lock:
                        dangling = ctx in sock.pipelined_contexts
                    if dangling:
                        sock.set_failed(errors.ECLOSE, "own pipelined "
                                        "context still outstanding")
        for ep, sock in d.get("_pooled_sockets", ()):
            SocketMap.instance().return_pooled_socket(
                ep, sock, group=self._protocol.name)
        for sock in d.get("_short_sockets", ()):
            sock.set_failed(errors.ECLOSE, "short connection done")
        sel = cntl._selected_endpoint
        if sel is None:
            return                       # no try was issued
        code = cntl.error_code_
        if code == errors.ELIMIT and cntl.retry_after_ms > 0:
            code = 0
        lb = self._lb
        if lb is not None:
            # balancer feedback sees the shed: steering weight away from
            # an overloaded member is right
            lb.feedback(sel, cntl.error_code_, cntl.latency_us)
        breaker = BreakerRegistry.instance().breaker(sel)
        if not breaker.on_call_end(code):
            from .health_check import start_health_check
            if lb is None:
                start_health_check(sel)
            else:
                # a balanced channel routes around the isolated member
                # until the checker's probe revives it
                lb.exclude(sel, breaker.isolated_until())
                start_health_check(sel,
                                   on_revived=lambda ep: lb.exclude(ep, 0.0))

    def close(self) -> None:
        """Tear down this channel's connections (failed with ECLOSE): the
        endpoint's, or every balanced member's, and detach from the
        naming watcher.  Idempotent; a later call on the channel simply
        reconnects."""
        if self._protocol is None:
            return
        smap = SocketMap.instance()
        with self._native_ici_lock:
            nch, self._native_ici = self._native_ici, None
        if nch is not None:
            nch.close()
        if self._endpoint is not None:
            smap.close_endpoint(self._endpoint, self._protocol.name)
        lb = self._lb
        if lb is not None:
            if self._ns_thread is not None:
                self._ns_thread.remove_watcher(self._ns_watcher)
            for e in lb.servers():
                smap.close_endpoint(e.endpoint, self._protocol.name)


class _FilteredWatcher:
    """A channel's filter over its naming service's members (reference
    naming_service_filter.h): the balancer sees only the entries the
    filter keeps."""

    def __init__(self, lb, filter_fn):
        self._lb = lb
        self._filter = filter_fn

    def reset_servers(self, entries):
        self._lb.reset_servers([e for e in entries if self._filter(e)])
