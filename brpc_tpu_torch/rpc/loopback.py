"""Loopback call plane: direct in-process dispatch for ``mem://`` channels.

When the client channel and the server live in one process, a unary
tpu_std call on ``mem://name`` skips the byte codec, the socket pair, the
event dispatch and the correlation id, and dispatches straight into the
server's method table (gRPC's in-process transport).  The semantics stay
the wire path's:

* admission: a draining server bounces with retryable ELOGOFF, then the
  admission controller decides, or without one the server's
  ``max_concurrency`` and the method's limiter reject with ELIMIT; an
  unknown method is ENOMETHOD or ENOSERVICE;
* accounting: ``Server.on_request_in/out``, the MethodStatus counters (the
  status page and the drain gate see loopback requests as wire ones) and
  the usercode pool's queued counter;
* isolation: the handler gets its own pooled server Controller and a
  request parsed from the serialized bytes (a handler that mutates its
  request never touches the caller's), and runs inline only on
  ``usercode_inline`` servers, else on a tasklet or the usercode pool;
* failure surface: ERPCTIMEDOUT at the caller's deadline and ECANCELED on
  ``Controller.cancel()``, with a late-completion guard (a response that
  lands after the claim is dropped), and a stop past its grace fails the
  stragglers with ELOGOFF as it fails the wire connections.

The channel screens which calls may take this plane (streaming, auth,
compression, hedging, fault injection, rpc_dump sampling, rpcz-sampled
calls and ``tpu_std_stage_metrics=on`` ride the wire path).

Attachments cross by reference: the handler's request attachment is the
caller's IOBuf and the response attachment moves back by reference, so a
DEVICE block crosses with no copy launched.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..butil import debug_sync as _dbg
from ..butil import flags as _flags
from ..butil import logging as log
from . import errors
from .controller import Controller, server_controller_pool

_loopback_flag = _flags.define_flag(
    "mem_loopback_fast", True,
    "direct in-process dispatch for unary tpu_std calls on mem:// "
    "channels (skips the byte codec and socket machinery; admission, "
    "limits, accounting and drain semantics are the wire path's).  Off "
    "sends every mem:// call through the wire plane.")

# mem name -> Server, kept by Server.start and its teardown
_servers: Dict[str, Any] = {}
_servers_lock = _dbg.make_lock("loopback._servers_lock")
# id(server) -> set of in-flight _CallStates (the stop's straggler view)
_inflight: Dict[int, set] = {}
_inflight_lock = _dbg.make_lock("loopback._inflight_lock")

_GUARDED_BY_GLOBALS = {"_servers": "_servers_lock", "_inflight": "_inflight_lock"}
# calls this plane served, process-wide
calls = 0


def register_server(name: str, server) -> None:
    with _servers_lock:
        _servers[name] = server


def unregister_server(name: str, server) -> None:
    with _servers_lock:
        if _servers.get(name) is server:
            del _servers[name]


def server_for(name: str):
    """The in-process Server listening on ``mem://<name>``, or None."""
    with _servers_lock:
        return _servers.get(name)


def enabled() -> bool:
    return bool(_loopback_flag.value)


class _CallState:
    """First of (completion, timeout, cancel, stop) wins: exactly one side
    writes the client-visible result, as the correlation id's version
    guard decides it on the wire path."""

    __slots__ = ("lock", "finished", "event", "server_key", "cntl",
                 "done", "t0")

    def __init__(self, server_key: int, cntl, done, t0: int):
        self.lock = threading.Lock()
        self.finished = False
        self.event: Optional[threading.Event] = None
        self.server_key = server_key
        self.cntl = cntl
        self.done = done
        self.t0 = t0

    def try_finish(self) -> bool:
        with self.lock:
            if self.finished:
                return False
            self.finished = True
            ev = self.event
        _inflight_remove(self)
        if ev is not None:
            ev.set()
        return True

    def wait_begin(self) -> Optional[threading.Event]:
        """The park event (made on first use); None when already
        finished."""
        with self.lock:
            if self.finished:
                return None
            if self.event is None:
                self.event = threading.Event()
            return self.event


def _inflight_add(state: _CallState) -> None:
    with _inflight_lock:
        _inflight.setdefault(state.server_key, set()).add(state)


def _inflight_remove(state: _CallState) -> None:
    with _inflight_lock:
        bucket = _inflight.get(state.server_key)
        if bucket is not None:
            bucket.discard(state)
            if not bucket:
                del _inflight[state.server_key]


def fail_inflight(server, code: int, text: str) -> int:
    """A stop's straggler handling: claim every in-flight loopback call on
    ``server`` with ``code``.  The handlers still running finish on their
    own and their late completion is dropped.  Returns the number
    failed."""
    with _inflight_lock:
        states = list(_inflight.get(id(server), ()))
    n = 0
    for st in states:
        if st.try_finish():
            st.cntl.set_failed(code, text)
            st.cntl.latency_us = (time.monotonic_ns() - st.t0) // 1000
            _finish_client(st.cntl, st.done)
            n += 1
    return n


def cancel(cntl: Controller) -> bool:
    """``Controller.cancel()``: claim an in-flight loopback call with
    ECANCELED (the late server completion is dropped)."""
    state = cntl.__dict__.get("_loopback_state")
    if state is None or not state.try_finish():
        return False
    cntl.set_failed(errors.ECANCELED, "canceled by caller")
    cntl.latency_us = (time.monotonic_ns() - state.t0) // 1000
    _finish_client(cntl, state.done)
    return True


def call(server, method_full_name: str, cntl: Controller, request: Any,
         response_cls: Any, done=None):
    """One loopback RPC.  Sync (``done`` None): returns the response, or
    None on failure, with ``cntl`` filled either way.  Async: runs
    ``done(cntl)`` after completion and returns None."""
    global calls
    calls += 1
    t0 = time.monotonic_ns()
    state = _CallState(id(server), cntl, done, t0)
    cntl._loopback_state = state
    _inflight_add(state)
    try:
        req_bytes = request.SerializeToString()
    except AttributeError:
        req_bytes = bytes(request) if request is not None else b""

    if server.options.usercode_inline:
        _serve(server, method_full_name, cntl, req_bytes, response_cls,
               state)
    else:
        # as InputMessenger dispatches: the usercode pool when there is
        # one (counted queued for the drain gate), else a tasklet
        pool = server.usercode_pool
        dispatched = False
        if pool is not None:
            server.on_usercode_queued()
            try:
                pool.submit(_serve_pooled, server, method_full_name, cntl,
                            req_bytes, response_cls, state)
                dispatched = True
            except RuntimeError:
                server.on_usercode_done()
        if not dispatched:
            from ..bthread import scheduler
            scheduler.start_background(
                _serve, server, method_full_name, cntl, req_bytes,
                response_cls, state, name=f"loopback:{method_full_name}")

    tms = cntl.timeout_ms
    if done is not None:
        if not state.finished and tms and tms > 0:
            from ..bthread.timer_thread import TimerThread
            TimerThread.instance().schedule_after(
                lambda: _timeout(cntl, state), tms / 1000.0)
        return None
    if not state.finished:
        ev = state.wait_begin()
        if ev is not None:
            from ..bthread import scheduler
            scheduler.note_worker_blocked()
            try:
                # the deadline is the caller's: ERPCTIMEDOUT the moment it
                # expires, while the server side runs on and its late
                # completion is dropped by the claim
                ev.wait(tms / 1000.0 if tms and tms > 0 else None)
            finally:
                scheduler.note_worker_unblocked()
            _timeout(cntl, state)
    return cntl.response if not cntl.failed() else None


def _timeout(cntl: Controller, state: _CallState) -> None:
    """The deadline: claim the completion if the server has not."""
    if not state.try_finish():
        return
    cntl.latency_us = (time.monotonic_ns() - state.t0) // 1000
    cntl.set_failed(errors.ERPCTIMEDOUT,
                    f"reached timeout={cntl.timeout_ms}ms")
    _finish_client(cntl, state.done)


def _finish_client(cntl: Controller, done) -> None:
    if cntl.span is not None:
        from .span import end_client_span
        end_client_span(cntl)
    if done is not None:
        from ..bthread import scheduler
        scheduler.start_background(done, cntl, name="rpc_done")


def _serve_pooled(server, full_name, cntl, req_bytes, response_cls,
                  state) -> None:
    try:
        _serve(server, full_name, cntl, req_bytes, response_cls, state)
    finally:
        server.on_usercode_done()


def _serve(server, full_name: str, client_cntl: Controller,
           req_bytes: bytes, response_cls, state: _CallState) -> None:
    """The server half: admission, then :func:`_execute`.  Runs inline on
    the caller (``usercode_inline``) or on a tasklet or pool thread."""
    t0 = state.t0
    done = state.done
    cntl = server_controller_pool.acquire()  # fablint: custody-moved(request-lifecycle) the shim rides the request; _maybe_recycle releases it back to the pool when the response (or failure path) completes
    cntl.server = server
    if client_cntl.log_id:
        cntl.log_id = client_cntl.log_id
    cntl.remote_side = cntl.local_side = server.listen_endpoint
    tms = client_cntl.timeout_ms
    # the request context crosses in process: the caller's controller is
    # the carrier, for every call (handlers read priority, tenant and
    # deadline_left_ms on every plane)
    cntl.priority = client_cntl.priority
    cntl.tenant = client_cntl.tenant
    if tms and tms > 0:
        cntl.deadline_left_ms = int(tms)

    def bail(code: int, text: str, status=None, counted=False,
             retry_after: int = 0) -> None:
        if status is not None:
            status.on_responded(code, 0)
        if counted:
            server.on_request_out()
        cntl._maybe_recycle()
        if not state.try_finish():
            return
        client_cntl.set_failed(code, text)
        if retry_after:
            client_cntl.retry_after_ms = retry_after
        client_cntl.latency_us = (time.monotonic_ns() - t0) // 1000
        _finish_client(client_cntl, done)

    if server.is_draining():
        bail(errors.ELOGOFF, "server is draining (lame duck)")
        return
    md = server.find_method(full_name)
    status = None
    if md is not None:
        status = server.method_status(full_name)
        if status is not None:
            status.received << 1
    adm = server.admission
    if adm is not None:
        # the wire plane's decision (shed before queue, fair queueing,
        # deadline shed): loopback is no back door around overload
        if md is None:
            service = full_name.rpartition(".")[0]
            bail(errors.ENOMETHOD if service in server.services()
                 else errors.ENOSERVICE, f"no method {full_name}")
            return
        from . import admission as admission_mod
        adm.submit(
            priority=client_cntl.priority, tenant=client_cntl.tenant,
            deadline_left_ms=int(tms) if tms and tms > 0 else None,
            recv_us=t0 // 1000,
            try_enter=admission_mod.server_method_gate(server, status),
            run=lambda queued_us: _execute(server, full_name, cntl,
                                           client_cntl, req_bytes,
                                           response_cls, state, md,
                                           status),
            shed=lambda code, text, ra: bail(code, text, retry_after=ra))
        return
    if not server.on_request_in():
        bail(errors.ELIMIT, "server max_concurrency reached")
        return
    if md is None:
        service = full_name.rpartition(".")[0]
        bail(errors.ENOMETHOD if service in server.services()
             else errors.ENOSERVICE, f"no method {full_name}",
             counted=True)
        return
    if status is not None and not status.on_requested():
        bail(errors.ELIMIT, f"method {full_name} max_concurrency reached",
             counted=True)
        return
    _execute(server, full_name, cntl, client_cntl, req_bytes,
             response_cls, state, md, status)


def _execute(server, full_name: str, cntl: Controller,
             client_cntl: Controller, req_bytes: bytes, response_cls,
             state: _CallState, md, status) -> None:
    """The gates are held: parse, invoke, and copy the completion back."""
    t0 = state.t0
    done = state.done
    start_us = time.monotonic_ns() // 1000
    try:
        request = md.request_cls()
        request.ParseFromString(req_bytes)
    except Exception as e:
        if status is not None:
            status.on_responded(errors.EREQUEST, 0)
        server.on_request_out()
        cntl._maybe_recycle()
        if state.try_finish():
            client_cntl.set_failed(errors.EREQUEST,
                                   f"fail to parse request: {e}")
            client_cntl.latency_us = (time.monotonic_ns() - t0) // 1000
            _finish_client(client_cntl, done)
        return
    # the handler sees the caller's request attachment (no copy);
    # session data stays lazy (Controller.session_local_data)
    req_att = client_cntl._peek_request_attachment()
    if req_att is not None:
        cntl.request_attachment = req_att
    response = md.response_cls()
    done_called = [False]

    def s_done() -> None:
        if done_called[0]:
            return
        done_called[0] = True
        err = cntl.error_code_
        if status is not None:
            status.on_responded(err, time.monotonic_ns() // 1000 - start_us)
        server.on_request_out()
        if state.try_finish():
            if err:
                client_cntl.set_failed(err, cntl.error_text_)
                # a handler's shed hint rides back as on the wire plane
                if cntl.retry_after_ms:
                    client_cntl.retry_after_ms = cntl.retry_after_ms
            else:
                resp_att = cntl._peek_response_attachment()
                if resp_att is not None and len(resp_att):
                    client_cntl.response_attachment = resp_att
                    # detach: the pooled Controller's reset must not drop
                    # the buffer the caller owns now
                    cntl.__dict__.pop("response_attachment", None)
                if response_cls is None:
                    client_cntl.response = response.SerializeToString()
                elif md.response_cls is response_cls:
                    client_cntl.response = response
                else:
                    out = response_cls()
                    out.ParseFromString(response.SerializeToString())
                    client_cntl.response = out
                client_cntl.error_code_ = 0
            client_cntl.latency_us = (time.monotonic_ns() - t0) // 1000
            _finish_client(client_cntl, done)
        # the caller timed out, canceled or was failed by a stop: the
        # completion is dropped, as a stale correlation version is
        cntl.__dict__.pop("request_attachment", None)
        cntl._release_session_data()
        cntl._maybe_recycle()

    cntl.set_server_done(s_done)
    try:
        md.invoke(cntl, request, response, s_done)
    except Exception as e:   # an uncaught handler exception: EINTERNAL
        log.error("method %s raised: %s", full_name, e, exc_info=True)
        if not done_called[0]:
            cntl.set_failed(errors.EINTERNAL, f"{type(e).__name__}: {e}")
            s_done()
