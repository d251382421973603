"""rpcz spans: per-RPC timelines, sampled through the bvar collector's
speed limit.

Reference: src/brpc/span.{h,cpp} (Span at span.h:47-150, the thread-local
parent at :115, SpanDB at :206-223) and builtin/rpcz_service.cpp, ported
from :mod:`brpc_tpu.rpc.span`.  Client and server spans record annotated
timelines; sampling is capped by ``CollectorSpeedLimit``; kept spans land in
an in-memory ring of ``rpcz_keep`` spans read by the /rpcz page and the
``brpc_tpu.Trace`` service.  Trace, span and parent ids ride the request's
RpcMeta, so a server span joins its caller's trace.

  * every span keeps a wall-clock anchor (``wall_us``) beside its
    monotonic timeline;
  * ``annotate_current`` reads the ACTIVE client span (published around
    the channel's write) before the bthread-local server span, so the
    client side's relocation and device-plane events are kept;
  * a device-plane transfer made under a span opens a **transfer span**
    of its own, parented under the RPC span that caused it, carrying the
    transfer's posted → matched → complete (or failed) timeline.

With ``rpcz_enabled`` off (the default) the hot path pays one attribute
read per call.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional, Tuple

from ..butil.misc import fast_rand
from ..butil import flags as _flags
from .. import bvar
from ..bthread import scheduler

_rpcz_flag = _flags.define_flag("rpcz_enabled", False,
                                "collect per-RPC rpcz spans")
_flags.define_flag("rpcz_keep", 1000, "spans kept in memory",
                   _flags.positive_integer)

_speed_limit = bvar.CollectorSpeedLimit()
_store_lock = threading.Lock()
_store: Deque["Span"] = collections.deque(maxlen=10000)


class Span:
    __slots__ = ("trace_id", "span_id", "parent_span_id", "is_client",
                 "method", "start_us", "wall_us", "end_us", "annotations",
                 "error_code", "remote_side", "request_size",
                 "response_size", "kind")

    def __init__(self, method: str, is_client: bool, trace_id: int = 0,
                 parent_span_id: int = 0, kind: Optional[str] = None):
        self.trace_id = trace_id or fast_rand()
        self.span_id = fast_rand()
        self.parent_span_id = parent_span_id
        self.is_client = is_client
        self.method = method
        self.start_us = time.monotonic_ns() // 1000
        self.wall_us = time.time_ns() // 1000
        self.end_us = 0
        self.annotations: List[Tuple[int, str]] = []
        self.error_code = 0
        self.remote_side = None
        self.request_size = 0
        self.response_size = 0
        self.kind = kind or ("client" if is_client else "server")

    def annotate(self, text: str) -> None:
        self.annotations.append((time.monotonic_ns() // 1000, text))

    def latency_us(self) -> int:
        return (self.end_us or time.monotonic_ns() // 1000) - self.start_us

    def describe(self) -> dict:
        return {
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent": f"{self.parent_span_id:016x}",
            "side": self.kind,
            "method": self.method,
            "start_real_us": self.wall_us,
            "latency_us": self.latency_us(),
            "error_code": self.error_code,
            "remote": str(self.remote_side),
            "annotations": [(t - self.start_us, a)
                            for t, a in self.annotations],
        }


def rpcz_enabled() -> bool:
    # one attribute load: this gate sits on every call
    return bool(_rpcz_flag.value)


def maybe_start_client_span(cntl, method: str) -> None:
    if not _rpcz_flag.value or not _speed_limit.is_sampled():
        return
    # a call made inside a handler joins the handler's trace
    parent: Optional[Span] = scheduler.local_get("rpcz_span")
    if parent is not None:
        span = Span(method, True, parent.trace_id, parent.span_id)
    else:
        span = Span(method, True)
    cntl.span = span
    cntl.trace_id = span.trace_id
    cntl.span_id = span.span_id
    cntl.parent_span_id = span.parent_span_id


def start_server_span(cntl, method: str, trace_id: int,
                      parent_span_id: int) -> None:
    if not _rpcz_flag.value or not _speed_limit.is_sampled():
        return
    span = Span(method, False, trace_id, parent_span_id)
    cntl.span = span
    scheduler.local_set("rpcz_span", span)


def current_span() -> Optional[Span]:
    """The span a deep subsystem should annotate: the ACTIVE client span
    while a channel writes (the innermost context), else the
    bthread-local server span."""
    span: Optional[Span] = scheduler.local_get("rpcz_client_span")
    if span is not None:
        return span
    return scheduler.local_get("rpcz_span")


def current_trace_context() -> Tuple[int, int]:
    """``(trace_id, span_id)`` of the span in scope, or ``(0, 0)``; the
    device plane captures it when a transfer is posted."""
    span = current_span()
    if span is None:
        return 0, 0
    return span.trace_id, span.span_id


def set_client_span_local(span: Optional[Span]) -> None:
    """Publish ``span`` as the active client span for the channel's
    encode and write (cleared with None after)."""
    scheduler.local_set("rpcz_client_span", span)


def annotate_current(text: str) -> None:
    """Annotate the span in scope (see :func:`current_span`), if sampling
    kept one."""
    if not _rpcz_flag.value:
        return
    span = current_span()
    if span is not None:
        span.annotate(text)


def start_transfer_span(method: str, trace_id: int,
                        parent_span_id: int) -> Span:
    """A data-plane event span (a device-plane transfer), stored like any
    RPC span and parented under the RPC span that caused it."""
    return Span(method, False, trace_id, parent_span_id, kind="transfer")


def end_span(span: Span, error_code: int = 0) -> None:
    """Close and store a span the caller owns (transfer spans)."""
    span.end_us = time.monotonic_ns() // 1000
    span.error_code = error_code
    store_span(span)


def store_span(span: Span) -> None:
    with _store_lock:
        _store.append(span)
        while len(_store) > _flags.get_flag("rpcz_keep"):
            _store.popleft()


def end_client_span(cntl) -> None:
    _finish(cntl)


def end_server_span(cntl) -> None:
    _finish(cntl)
    scheduler.local_set("rpcz_span", None)


def _finish(cntl) -> None:
    span = cntl.span
    if span is None:
        return
    span.end_us = time.monotonic_ns() // 1000
    span.error_code = cntl.error_code_
    span.remote_side = cntl.remote_side
    store_span(span)
    cntl.span = None


def recent_spans(limit: int = 100) -> List[Span]:
    with _store_lock:
        return list(_store)[-limit:]


def find_trace(trace_id: int) -> List[Span]:
    with _store_lock:
        return [s for s in _store if s.trace_id == trace_id]
