"""Controller: per-RPC state machine for both client and server sides.

Reference: src/brpc/controller.{h,cpp}.  Client-side lifecycle of a unary
call:

  Channel.call_method
    → correlation id created ranged over max_retry+1 try-versions
      (channel.cpp:442): try k sends version k; a retry advances the
      current version so older tries' responses fail to lock (ignored); a
      backup request (``backup_request_ms``) or a timeout hedge
      (``retry_on_timeout``) leaves older versions valid, so the first
      response to arrive wins
    → deadline and backup timers through TimerThread (channel.cpp:537-574)
    → issue_rpc: pick socket, pack, Socket.write (controller.cpp:985-1144)
    → completion funnels through the correlation id's on_error/lock — the
      single synchronization point (OnVersionedRPCReturned controller.cpp:568)
    → a connection-class failure retries at once, or after
      ``retry_backoff_ms`` doubling per retry with seeded jitter; an ELIMIT
      shed with a retry_after_ms hint is retried after the hint
      (admission.shed_backoff_s), from the timer thread, while tries
      remain.  The hint gates every re-dispatch: a shed disarms the backup
      timer, so a hedged call never re-dispatches ahead of it
    → ``cancel()`` ends the call with ECANCELED; a late response is
      dropped by the correlation id

Server side carries the request's attachment and peer, and the session
data a handler asks for (``session_local_data``); its Controllers come
from a pool.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional

from ..butil.iobuf import IOBuf
from ..butil.endpoint import EndPoint
from ..butil.resource_pool import ResourcePool
from ..bthread import id as bthread_id
from ..bthread.timer_thread import TimerThread
from . import errors
from .admission import shed_backoff_s


class _LazyField:
    """Non-data descriptor: materializes a per-instance default on first
    READ (the instance dict shadows it afterwards).  A request that never
    touches its attachments never pays for their IOBufs."""
    __slots__ = ("name", "factory")

    def __init__(self, name: str, factory):
        self.name = name
        self.factory = factory

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        val = obj.__dict__[self.name] = self.factory()
        return val


class Controller:
    # Every scalar default lives on the CLASS: __init__ sets nothing, so a
    # pooled reset is one ``__dict__.clear()`` (reference ResetPods).
    error_code_: int = 0
    error_text_: str = ""
    log_id: int = 0
    request_attachment = _LazyField("request_attachment", IOBuf)
    response_attachment = _LazyField("response_attachment", IOBuf)
    remote_side: Optional[EndPoint] = None
    # request context carried in RequestMeta on every call: the priority
    # band (0 = most protected; None = the server's default band) and the
    # fair-queueing tenant, set by a client and read by a handler;
    # deadline_left_ms is the budget left when the request arrived (server
    # side) and retry_after_ms the backoff hint a shedding handler sets
    # and its caller reads
    priority: Optional[int] = None
    tenant: str = ""
    retry_after_ms: int = 0
    deadline_left_ms: int = 0
    # the credential the call carries (a channel's authenticator fills it
    # when empty; a server reads the caller's here) and the compression
    # of the request and response bodies (rpc/compress.py; 0 = none)
    auth_token: str = ""
    compress_type: int = 0
    # server side: the monotonic time at which the caller gives up (from
    # tpu_std's timeout or gRPC's grpc-timeout), or None
    method_deadline: Optional[float] = None
    # client call state; None takes the channel's option
    timeout_ms: Optional[int] = None
    max_retry: Optional[int] = None
    backup_request_ms: Optional[int] = None
    retry_on_timeout: Optional[bool] = None
    retry_backoff_ms: Optional[int] = None
    retried_count: int = 0
    current_try: int = 0
    latency_us: int = 0
    response: Any = None
    _response_cls: Any = None
    _done: Optional[Callable[["Controller"], None]] = None
    _cid: int = 0
    _timeout_timer = None
    _backup_timer = None
    _channel = None                 # issuing channel (for re-issues)
    _method_full_name: str = ""
    _request_buf: Optional[IOBuf] = None
    _start_us: int = 0
    _ended_ev: Optional[threading.Event] = None
    _selected_endpoint: Optional[EndPoint] = None   # the try's endpoint
    # servers this call's retries steer away from (balanced channels)
    _excluded_servers = _LazyField("_excluded_servers", set)
    # the (endpoint, socket) of each try that took a pooled connection,
    # and each short connection (channel.py): returned or closed when the
    # call ends, every try's (a backup try's answer may win)
    _pooled_sockets = _LazyField("_pooled_sockets", list)
    _short_sockets = _LazyField("_short_sockets", list)
    # (socket, context) of each try on a pipelined protocol (http)
    _pipelined = _LazyField("_pipelined", list)
    _pack_socket = None                 # the try's socket (h2 packs on it)
    # consistent-hashing key of the call (balanced channels)
    request_code: Any = None
    # streaming RPC (rpc/stream.py): the client's stream, set by
    # stream_create before the call, whose id rides the request as the
    # handshake; the server's accepted stream id, set by stream_accept
    # inside the handler, which the response echoes back
    stream_creator: Any = None
    accepted_stream_id: int = 0
    # compiled fan-out call state (channels/collective_fanout.py): the
    # typed operand the caller scatters across a Parallel/Partition
    # fan-out, the merged result, and which route carried the call
    # ("collective" = the compiled plane, "rpc" = the per-member loop, ""
    # = not an operand fan-out)
    fanout_operand: Any = None
    fanout_result: Any = None
    fanout_route: str = ""
    # rpcz (rpc/span.py): the call's span while it runs, and the ids a
    # sampled call carried
    span: Any = None
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    # server side: the Server whose handler runs the request, and the
    # session data it lent this request
    server: Any = None
    _session_data: Any = None

    def _peek_request_attachment(self) -> Optional[IOBuf]:
        """The request attachment if one was touched."""
        return self.__dict__.get("request_attachment")

    def _peek_response_attachment(self) -> Optional[IOBuf]:
        """The response attachment if one was touched (reading the field
        would materialize an empty IOBuf)."""
        return self.__dict__.get("response_attachment")

    # ---- per-RPC session data (reference Controller::session_local_data,
    # backed by ServerOptions.session_local_data_factory's pool) ---------
    def session_local_data(self) -> Any:
        """Server side: an object from the server's session pool, lent to
        this request until its response is sent (None without a
        ``session_local_data_factory``)."""
        if self._session_data is None and self.server is not None:
            self._session_data = self.server._get_session_data()
        return self._session_data

    def _release_session_data(self) -> None:
        # idempotent: the response path calls it once the reply is sent
        if self._session_data is not None and self.server is not None:
            self.server._return_session_data(self._session_data)
            self._session_data = None

    _ended_create_lock = threading.Lock()

    @property
    def _ended(self) -> threading.Event:
        """Completion event, created on first touch (double-checked under
        a class lock: a completer's set() and a joiner's wait() may both
        be the first toucher)."""
        ev = self._ended_ev
        if ev is None:
            with Controller._ended_create_lock:
                ev = self._ended_ev
                if ev is None:
                    ev = self._ended_ev = threading.Event()
        return ev

    # ---- error surface (reference Controller::SetFailed/Failed) -------
    def set_failed(self, code: int, text: str = "") -> None:
        self.error_code_ = code
        self.error_text_ = text or errors.berror(code)

    def failed(self) -> bool:
        return self.error_code_ != 0

    @property
    def error_code(self) -> int:
        return self.error_code_

    @property
    def error_text(self) -> str:
        return self.error_text_

    def reset(self) -> None:
        # every field is a class default: clearing the instance dict
        # restores pristine state in one C-level op
        self.__dict__.clear()

    # ---- server side: respond outside the handler's done --------------
    def set_server_done(self, fn: Callable[[], None]) -> None:
        self._server_done = fn

    def send_response(self) -> None:
        """Send the response now, as the handler's ``done`` would (once:
        a later ``done`` is a no-op)."""
        fn = self.__dict__.get("_server_done")
        if fn is not None:
            self._server_done = None
            fn()

    def _maybe_recycle(self) -> None:
        """Return a pool-acquired server-side Controller to its pool once
        the response is sent.  No-op for plain Controllers."""
        pool = self.__dict__.get("_recycle_pool")
        if pool is not None:
            pool.release(self)

    # ---- client call orchestration ------------------------------------
    def _start_call(self, channel, method_full_name: str, request_buf: IOBuf,
                    response_cls, done) -> None:
        self._channel = channel
        self._method_full_name = method_full_name
        self._request_buf = request_buf
        self._response_cls = response_cls
        self._done = done
        self._start_us = time.monotonic_ns() // 1000
        opts = channel.options
        if self.timeout_ms is None:
            self.timeout_ms = opts.timeout_ms
        if self.max_retry is None:
            self.max_retry = opts.max_retry
        if self.backup_request_ms is None:
            self.backup_request_ms = opts.backup_request_ms
        if self.retry_on_timeout is None:
            self.retry_on_timeout = opts.retry_on_timeout
        if self.retry_backoff_ms is None:
            self.retry_backoff_ms = opts.retry_backoff_ms
        # +1: versions are try indices 0..max_retry
        self._cid = bthread_id.create_ranged(
            self, self._on_rpc_event, self.max_retry + 1)
        if (self.backup_request_ms and self.backup_request_ms > 0
                and self.backup_request_ms < (self.timeout_ms or 1 << 30)):
            # armed before the first try leaves
            self._backup_timer = TimerThread.instance().schedule_after(
                self._handle_backup_request, self.backup_request_ms / 1000.0)
        self._issue_rpc()
        # the deadline timer is only needed if the call is still in flight
        # — inline device completions skip the timer heap entirely
        if (self.timeout_ms and self.timeout_ms > 0
                and not self._ended.is_set()):
            self._schedule_try_timer()

    def _timeout_hedging(self) -> bool:
        """Per-try deadline hedging: opted in with ``retry_on_timeout``,
        and off when ``backup_request_ms`` is set (that is an explicit
        hedging schedule already; both would burn the retry budget)."""
        return bool(self.retry_on_timeout) and not self.backup_request_ms

    def _schedule_try_timer(self) -> None:
        """Arm the deadline timer for the current try.  By default
        timeout_ms is a single overall deadline and ERPCTIMEDOUT is final
        (reference HandleTimeout).  With timeout hedging the deadline left
        is split evenly over the tries left: a try that gets neither a
        response nor a connection error has its share before the
        correlation id is poked with ERPCTIMEDOUT, and the funnel hedges
        a fresh try instead of failing.  The total deadline always holds.
        The try version is bound now, so a stale timer that already
        popped cannot poke a later try."""
        if self._timeout_timer is not None:
            TimerThread.instance().unschedule(self._timeout_timer)
            self._timeout_timer = None
        if not self.timeout_ms or self.timeout_ms <= 0 or self._ended.is_set():
            return
        elapsed_ms = (time.monotonic_ns() // 1000 - self._start_us) / 1000.0
        remaining = max(0.0, self.timeout_ms - elapsed_ms)
        if self._timeout_hedging():
            tries_left = max(1, (self.max_retry or 0) - self.current_try + 1)
            remaining = remaining / tries_left
        ver = self.current_try
        self._timeout_timer = TimerThread.instance().schedule_after(
            lambda: self._handle_timeout(ver), remaining / 1000.0)

    def current_cid(self) -> int:
        return bthread_id.with_version(self._cid, self.current_try)

    def _issue_rpc(self) -> None:
        try:
            self._channel._issue_rpc(self)
        except Exception:
            bthread_id.error(self.current_cid(), errors.EFAILEDSOCKET)

    def _handle_timeout(self, ver: int) -> None:
        bthread_id.error(bthread_id.with_version(self._cid, ver),
                         errors.ERPCTIMEDOUT)

    def _handle_backup_request(self) -> None:
        bthread_id.error(bthread_id.with_version(self._cid, self.current_try),
                         errors.EBACKUPREQUEST)

    # the correlation-id funnel (always entered with the id locked) ------
    def _on_rpc_event(self, data, cid: int, error_code: int) -> None:
        """on_error callback: timeout, backup trigger, cancel, send
        failure or socket death all land here — the retry decision
        point."""
        if bthread_id.get_version(cid) < self.current_try \
                and error_code not in (errors.EBACKUPREQUEST,
                                       errors.ECANCELED):
            # a straggler: an older try died after a newer one was issued.
            # Hedging keeps old versions lockable so their slow responses
            # can still win, but their failures must not decide the call
            # nor blacklist the live try's server
            bthread_id.unlock(cid)
            return
        if error_code == errors.EBACKUPREQUEST:
            # hedge: one more try; older versions stay valid so the first
            # response wins.  The timer stays armed across a shed, so a
            # backup may go out before the shed's hint has passed, as in
            # the reference
            if self.current_try < self.max_retry:
                self.current_try += 1
                self.retried_count += 1
                # the deadline timer is version-bound: re-armed at the new
                # version, or the straggler guard would swallow it
                self._schedule_try_timer()
                self._issue_rpc()
            bthread_id.unlock(cid)
            return
        if error_code == errors.ERPCTIMEDOUT:
            elapsed_ms = (time.monotonic_ns() // 1000
                          - self._start_us) / 1000.0
            remaining = (self.timeout_ms or 0) - elapsed_ms
            if (self._timeout_hedging() and remaining > 1.0
                    and self.current_try < self.max_retry):
                # this try's share elapsed with no reply: hedge a fresh
                # try.  Old versions stay valid (no reset_version), so a
                # merely slow response still wins; the silent server is
                # excluded so a balancer steers elsewhere
                sel = self._selected_endpoint
                if sel is not None:
                    self._excluded_servers.add(sel)
                self.current_try += 1
                self.retried_count += 1
                self._schedule_try_timer()
                self._issue_rpc()
                bthread_id.unlock(cid)
                return
            self.set_failed(errors.ERPCTIMEDOUT,
                            f"reached timeout={self.timeout_ms}ms")
            self._end_rpc(cid)
            return
        if self._retryable(error_code) and self.current_try < self.max_retry:
            sel = self._selected_endpoint
            if sel is not None:
                self._excluded_servers.add(sel)   # per-call blacklist
            self.current_try += 1
            self.retried_count += 1
            bthread_id.reset_version(self._cid, self.current_try)
            self._schedule_try_timer()
            # a lame-duck bounce (ELOGOFF) is the peer saying "go
            # elsewhere", an instant failover, not an outage: it takes no
            # backoff
            delay_s = 0.0 if error_code == errors.ELOGOFF \
                else self._retry_backoff_s()
            if delay_s > 0:
                # spaced retries ride out an outage until the health
                # check revives the peer; a delay past the deadline loses
                # to ERPCTIMEDOUT, which is the right bound
                TimerThread.instance().schedule_after(
                    self._start_delayed_retry, delay_s)
            else:
                self._issue_rpc()
            bthread_id.unlock(cid)
            return
        sock = self.__dict__.get("_try_socket")
        text = ""
        if (error_code == errors.EINTERNAL and sock is not None
                and sock.failed_error == errors.EINTERNAL):
            text = sock.failed_reason
        self.set_failed(error_code, text)
        self._end_rpc(cid)

    def _retry_backoff_s(self) -> float:
        """Exponential backoff with jitter seeded by (cid, retry) for a
        connection-class retry; 0 unless ``retry_backoff_ms`` is set."""
        base_ms = self.retry_backoff_ms or 0
        if base_ms <= 0:
            return 0.0
        delay_ms = min(base_ms * (2 ** (self.retried_count - 1)), 1000.0)
        rng = random.Random((self._cid << 8) ^ self.retried_count)
        return delay_ms * (1.0 + 0.25 * rng.random()) / 1000.0

    @staticmethod
    def _retryable(error_code: int) -> bool:
        return error_code in (errors.EFAILEDSOCKET, errors.EEOF,
                              errors.ELOGOFF, errors.ECONNREFUSED,
                              errors.ECONNRESET, errors.EAGAIN)

    def handle_response(self, cid: int, meta, payload: IOBuf) -> None:
        """Called by the protocol with the correlation id locked and
        validated (stale tries never get here)."""
        rmeta = meta.response
        if rmeta.error_code != 0:
            if bthread_id.get_version(cid) < self.current_try:
                # hedging keeps old versions lockable so a slow success
                # can win, but an abandoned try's error must not decide
                # the call (the straggler rule of _on_rpc_event)
                bthread_id.unlock(cid)
                return
            err = rmeta.error_code
            self.set_failed(err, rmeta.error_text)
            hint_ms = rmeta.retry_after_ms
            if hint_ms:
                self.retry_after_ms = hint_ms
            # an admission shed (ELIMIT + retry_after_ms) is retryable, but
            # only after the server's hint: an immediate re-dispatch would
            # be the retry storm the shed exists to prevent
            shed_retry = err == errors.ELIMIT and hint_ms > 0
            if (self._retryable(err) or shed_retry) \
                    and self.current_try < self.max_retry:
                # the retry lands on another replica where there is one: a
                # server that pushed a retryable error will push it again
                sel = self._selected_endpoint
                if sel is not None:
                    self._excluded_servers.add(sel)
                self.error_code_ = 0
                self.error_text_ = ""
                self.current_try += 1
                self.retried_count += 1
                bthread_id.reset_version(self._cid, self.current_try)
                self._schedule_try_timer()
                if shed_retry:
                    # issued from the timer thread after the hint plus
                    # jitter above it; a delay past the overall deadline
                    # loses to ERPCTIMEDOUT, which is the right bound
                    delay_s = shed_backoff_s(
                        hint_ms, seed=(self._cid << 8) ^ self.retried_count)
                    TimerThread.instance().schedule_after(
                        self._start_shed_retry, delay_s)
                else:
                    self._issue_rpc()
                bthread_id.unlock(cid)
                return
            self._end_rpc(cid)
            return
        try:
            att_size = meta.attachment_size
            body = payload
            if att_size:
                att = IOBuf()
                keep = len(body) - att_size
                tmp = body.cut(keep)
                body.cutn(att, att_size)
                body = tmp
                self.response_attachment = att
            data = body.to_bytes()
            if meta.compress_type:
                from .compress import decompress
                data = decompress(meta.compress_type, data)
            if self._response_cls is not None:
                resp = self._response_cls()
                resp.ParseFromString(data)
                self.response = resp
            else:
                self.response = data
        except Exception as e:
            self.set_failed(errors.ERESPONSE, f"fail to parse response: {e}")
        self._end_rpc(cid)

    def finish_parsed_response(self, cid: int) -> None:
        """Completion for protocols that parse the response themselves
        (http, grpc): ``response`` is already set."""
        self._end_rpc(cid)

    def _start_shed_retry(self) -> None:
        """Timer callback: re-issue a shed call off the timer thread,
        unless the call already ended (its deadline, a cancel, or a backup
        try's answer)."""
        self._start_delayed_retry()

    def _start_delayed_retry(self) -> None:
        """Timer callback: re-issue a backed-off call off the timer
        thread, unless it already ended (deadline, cancel)."""
        if self._ended.is_set():
            return
        from ..bthread import scheduler
        scheduler.start_background(self._issue_rpc, name="delayed_retry")

    def _end_rpc(self, cid: int) -> None:
        if self._timeout_timer is not None:
            TimerThread.instance().unschedule(self._timeout_timer)
        if self._backup_timer is not None:
            TimerThread.instance().unschedule(self._backup_timer)
        self.latency_us = time.monotonic_ns() // 1000 - self._start_us
        if self._channel is not None:     # a replayed frame has none
            self._channel._on_call_end(self)
        if self.span is not None:
            from .span import end_client_span
            end_client_span(self)
        done = self._done
        bthread_id.unlock_and_destroy(cid)   # wakes sync joiner
        self._ended.set()
        if done is not None:
            from ..bthread import scheduler
            scheduler.start_background(done, self, name="rpc_done")

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for RPC completion (sync calls).  When the caller is a
        scheduler tasklet, compensate the blocked worker so server-side
        processing can't be starved by sync callers."""
        from ..bthread import scheduler
        state = self.__dict__.get("_loopback_state")
        if state is not None:
            # a loopback call completes through its claim, not the id
            ev = state.wait_begin()
            if ev is None:
                return
            scheduler.note_worker_blocked()
            try:
                if not ev.wait(timeout):
                    raise TimeoutError("RPC join timed out")
            finally:
                scheduler.note_worker_unblocked()
            return
        scheduler.note_worker_blocked()
        try:
            if not self._ended.wait(timeout):
                raise TimeoutError("RPC join timed out")
        finally:
            scheduler.note_worker_unblocked()

    def cancel(self) -> None:
        """Cancel the in-flight call (reference StartCancel): it completes
        with ECANCELED, and a late response is dropped by the correlation
        id, which the completion destroyed."""
        if self.__dict__.get("_loopback_state") is not None:
            from . import loopback
            loopback.cancel(self)
            return
        if self._cid and not self._ended.is_set():
            bthread_id.error(
                bthread_id.with_version(self._cid, self.current_try),
                errors.ECANCELED)


class ControllerPool:
    """Server-side Controller pool.  In-use shims are tracked through a
    versioned-id ResourcePool — ``live()`` is the census, and a double
    release is rejected by the id version instead of corrupting the free
    list.  Reset is ``Controller.reset()`` (one dict clear), so a recycled
    shim never leaks request k's error code or attachment into k+1."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._ids: "ResourcePool[Controller]" = ResourcePool()
        self._free: list = []
        self._lock = threading.Lock()

    def acquire(self) -> Controller:
        with self._lock:
            c = self._free.pop() if self._free else None
        if c is None:
            c = Controller()
        d = c.__dict__
        d["_pool_rid"] = self._ids.get_resource(c)
        d["_recycle_pool"] = self
        return c

    def release(self, c: Controller) -> None:
        rid = c.__dict__.get("_pool_rid", 0)
        if not rid or not self._ids.return_resource(rid):
            return                   # not ours / already released: drop
        # a native attachment view whose handle never left custody (the
        # handler ignored it, or the response failed before passing it
        # back) is disposed here; plain IOBufs have no such hook
        d = c.__dict__
        for name in ("request_attachment", "response_attachment"):
            fn = getattr(d.get(name), "_dispose_native", None)
            if fn is not None:
                fn()
        c.reset()
        with self._lock:
            if len(self._free) < self.capacity:
                self._free.append(c)

    def live(self) -> int:
        """Controllers currently handed out (in-flight requests)."""
        return self._ids.size()

    def live_controllers(self) -> list:
        return self._ids.live_payloads()

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)


# The process-wide server-side pool tpu_std draws per-request Controllers
# from.
server_controller_pool = ControllerPool()
