"""Channel: the client stub.

Reference: src/brpc/channel.{h,cpp} (Init :236-393, CallMethod :407-592) and
Controller::IssueRPC (controller.cpp:985-1144).  A channel targets one
``ici://k`` or ``mem://name`` endpoint over tpu_std; per-call state lives in
the Controller.  A call made inside a handler inherits the inbound
request's context (:mod:`.request_context`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from . import errors
from . import request_context as _reqctx
from ..butil.endpoint import (EndPoint, parse_endpoint, SCHEME_ICI,
                               SCHEME_MEM)
from .controller import Controller
from .input_messenger import InputMessenger
from .protocol import find_protocol
from .socket_map import SocketMap


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
        self._protocol = None
        self.messenger = InputMessenger(server=None)

    # ---- init ---------------------------------------------------------
    def init(self, target: Any, options: Optional[ChannelOptions] = None) -> int:
        if options is not None:
            self.options = options
        self._protocol = find_protocol("tpu_std")
        if self._protocol is None:
            raise ValueError("tpu_std is not registered: import "
                             "brpc_tpu_torch.policy")
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
        cntl._start_call(self, method_full_name, payload, response_cls, done)
        if done is None:
            timeout = ((cntl.timeout_ms or 0) / 1000.0 + 35.0)
            cntl.join(timeout)
            return cntl.response
        return None

    # IssueRPC: runs once per try -----------------------------------------
    def _issue_rpc(self, cntl: Controller) -> None:
        sock = SocketMap.instance().get_socket(
            self._endpoint, self.messenger, group=self._protocol.name)
        cntl.remote_side = sock.remote_side
        cid = cntl.current_cid()
        packet = self._protocol.pack_request(
            cntl._request_buf, cid, cntl, cntl._method_full_name)
        rc = sock.write(packet, notify_cid=cid)
        if rc != 0:
            raise ConnectionError(f"write failed: {rc}")

    def close(self) -> None:
        """Tear down this channel's connection (failed with ECLOSE).
        Idempotent; a later call on the channel simply reconnects."""
        if self._endpoint is not None and self._protocol is not None:
            SocketMap.instance().close_endpoint(self._endpoint,
                                                self._protocol.name)
