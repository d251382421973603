"""Cascading request context: a handler's outbound calls inherit the
inbound request's admission metadata by default.

Port of :mod:`brpc_tpu.rpc.request_context`.  ``priority``, ``tenant`` and
``deadline_left_ms`` ride the wire on every call, but a service that fans
out (router → prefill → decode) would otherwise re-originate each
outbound call with channel defaults: a critical-band request could spawn
default-band sub-calls, and a nearly spent budget would reset to the full
channel timeout at each hop.

A thread-scoped inbound context is installed around the handler's
synchronous body (``MethodDescriptor.invoke``) and consulted by
``Channel.call_method``:

  * ``priority`` / ``tenant``: inherited unless the CALL sets them; the
    inherited value beats channel-wide ``ChannelOptions`` defaults.
  * deadline: the outbound timeout is capped at the inbound budget minus
    the time this handler already spent (monotonic, from handler entry).
    A spent budget fails the call with ``ERPCTIMEDOUT`` before anything
    is sent.

Scope: the handler's synchronous body and everything it calls on the same
thread.  Work handed to other threads re-originates.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

_tls = threading.local()


class InboundContext:
    """Snapshot of one inbound request's admission metadata, anchored at
    handler entry for the deadline decrement."""

    __slots__ = ("priority", "tenant", "deadline_left_ms", "entry_mono")

    def __init__(self, priority: Optional[int], tenant: str,
                 deadline_left_ms: int):
        self.priority = priority
        self.tenant = tenant
        self.deadline_left_ms = deadline_left_ms
        self.entry_mono = time.monotonic()

    def residual_deadline_ms(self) -> Optional[float]:
        """Inbound budget minus handler time already spent; None when the
        inbound request carried no budget."""
        if not self.deadline_left_ms:
            return None
        spent_ms = (time.monotonic() - self.entry_mono) * 1000.0
        return self.deadline_left_ms - spent_ms


def current() -> Optional[InboundContext]:
    return getattr(_tls, "ctx", None)


class scope:
    """Install the inbound context for one handler invocation; the
    previous one is restored on exit (a nested inline dispatch sees its
    own request's context, then the outer one again)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, cntl):
        pri = getattr(cntl, "priority", None)
        ten = getattr(cntl, "tenant", "") or ""
        ddl = getattr(cntl, "deadline_left_ms", 0) or 0
        self._ctx = (InboundContext(pri, ten, int(ddl))
                     if pri is not None or ten or ddl else None)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
