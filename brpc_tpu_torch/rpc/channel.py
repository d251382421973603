"""Channel: the client stub.

Reference: src/brpc/channel.{h,cpp} (Init :236-393, CallMethod :407-592) and
Controller::IssueRPC (controller.cpp:985-1144).  A channel targets one
``ici://k`` or ``mem://name`` endpoint, or a naming url (``list://``,
``file://``, ``mesh://``) whose members a load balancer picks from per
try, over tpu_std; per-call state lives in the Controller.  ``init`` takes
the reference's signature, ``init(target, lb_name="", options=None)``.  A
call made inside a handler inherits the inbound request's context
(:mod:`.request_context`).  Every call's outcome feeds the endpoint's
circuit breaker; while the breaker isolates the endpoint a call fails fast
instead of stampeding a recovering peer (a balanced channel excludes it
from its balancer instead), and the health checker's probe lifts the
isolation (:mod:`.circuit_breaker`, :mod:`.health_check`).  A streaming
call (``cntl.stream_creator`` set) rides one connection: it takes no
retry, and a balanced channel refuses it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from . import errors
from . import request_context as _reqctx
from .circuit_breaker import BreakerRegistry
from ..butil.endpoint import (EndPoint, parse_endpoint, SCHEME_ICI,
                               SCHEME_MEM)
from .controller import Controller
from .input_messenger import InputMessenger
from .protocol import find_protocol
from .socket_map import SocketMap
from .span import (maybe_start_client_span, set_client_span_local,
                   _rpcz_flag as _rpcz)
from ..bthread import scheduler as _sched


@dataclass
class ChannelOptions:
    timeout_ms: int = 1000
    max_retry: int = 3
    # admission defaults for every call on the channel: a call's own
    # Controller values win, then the inbound request's, then these
    priority: Optional[int] = None
    tenant: str = ""


class Channel:
    def __init__(self):
        self.options = ChannelOptions()
        self._endpoint: Optional[EndPoint] = None
        self._lb = None                  # balancer over a naming url
        self._ns_thread = None
        self._protocol = None
        self.messenger = InputMessenger(server=None)

    # ---- init ---------------------------------------------------------
    def init(self, target: Any, lb_name: str = "",
             options: Optional[ChannelOptions] = None) -> int:
        """``target`` is an endpoint (``ici://k``, ``mem://name`` or an
        EndPoint) or a naming url, whose members ``lb_name``'s balancer
        (round robin when empty) picks from."""
        if options is not None:
            self.options = options
        self._protocol = find_protocol("tpu_std")
        if self._protocol is None:
            raise ValueError("tpu_std is not registered: import "
                             "brpc_tpu_torch.policy")
        from ..policy.naming import is_naming_url
        if isinstance(target, str) and is_naming_url(target):
            from ..policy.load_balancers import create_load_balancer
            from ..policy.naming import get_naming_service_thread
            self._lb = create_load_balancer(lb_name or "rr")
            self._ns_thread = get_naming_service_thread(target)
            self._ns_thread.add_watcher(self._lb)
            return 0
        ep = parse_endpoint(target) if isinstance(target, str) else target
        if ep.scheme not in (SCHEME_ICI, SCHEME_MEM):
            raise ValueError(f"unsupported scheme {ep.scheme}: the port "
                             "connects ici:// and mem:// only")
        self._endpoint = ep
        return 0

    # ---- calls ----------------------------------------------------------
    def call_method(self, method_full_name: str, cntl: Controller,
                    request: Any, response_cls: Any = None,
                    done: Optional[Callable[[Controller], None]] = None):
        """Sync when done is None (returns the response); async otherwise."""
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
        payload = self._protocol.serialize_request(request, cntl)
        if _rpcz.value and cntl.span is None:
            maybe_start_client_span(cntl, method_full_name)
        cntl._start_call(self, method_full_name, payload, response_cls, done)
        if done is None:
            timeout = ((cntl.timeout_ms or 0) / 1000.0 + 35.0)
            cntl.join(timeout)
            return cntl.response
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
        sock = SocketMap.instance().get_socket(
            ep, self.messenger, group=self._protocol.name)
        cntl.remote_side = sock.remote_side
        cid = cntl.current_cid()
        packet = self._protocol.pack_request(
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

    def _on_call_end(self, cntl: Controller) -> None:
        """Feed the endpoint's breaker; a trip hands the endpoint to the
        health checker, whose successful probe resets the breaker.  An
        admission shed (ELIMIT with a retry_after_ms hint) is a healthy
        server saying "not now": it counts as a success here, or an
        overload would isolate the server still serving its protected
        band."""
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
        if self._endpoint is not None:
            smap.close_endpoint(self._endpoint, self._protocol.name)
        lb = self._lb
        if lb is not None:
            if self._ns_thread is not None:
                self._ns_thread.remove_watcher(lb)
            for e in lb.servers():
                smap.close_endpoint(e.endpoint, self._protocol.name)
