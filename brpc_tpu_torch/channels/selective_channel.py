"""SelectiveChannel: load balancing *between* channels.

Reference: src/brpc/selective_channel.{h,cpp} (AddChannel :69), ported
from :mod:`brpc_tpu.channels.selective_channel`.  Each
sub-channel (often itself a ParallelChannel or a channel over a different
cluster/slice) is a selection unit; failed calls retry on a DIFFERENT
sub-channel.  The reference wraps each sub-channel in a fake Socket to
reuse socket-level LB/health machinery; here selection units carry their own
health (circuit breaker per unit) and the channel-level LB excludes broken
units — same observable behavior, no fake fds.  Each unit's breaker is
the port's :class:`~..rpc.circuit_breaker.CircuitBreaker`.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ..rpc import errors
from ..rpc.circuit_breaker import CircuitBreaker
from ..rpc.controller import Controller
from .parallel_channel import _join_timeout_s


class _Unit:
    def __init__(self, channel, index: int):
        self.channel = channel
        self.index = index
        self.breaker = CircuitBreaker()


class SelectiveChannel:
    def __init__(self, max_retry: int = 2):
        self._units: List[_Unit] = []
        self._index = 0
        self._lock = threading.Lock()
        self.max_retry = max_retry

    def add_channel(self, channel) -> int:
        """Returns a channel handle (index) like the reference's
        ChannelHandle."""
        with self._lock:
            u = _Unit(channel, len(self._units))
            self._units.append(u)
            return u.index

    def remove_and_destroy_channel(self, handle: int) -> None:
        with self._lock:
            self._units = [u for u in self._units if u.index != handle]

    def channel_count(self) -> int:
        with self._lock:
            return len(self._units)

    def _select(self, excluded: set) -> Optional[_Unit]:
        with self._lock:
            usable = [u for u in self._units
                      if u.index not in excluded and not u.breaker.is_isolated()]
            if not usable:
                usable = [u for u in self._units if u.index not in excluded]
            if not usable:
                return None
            self._index = (self._index + 1) % len(usable)
            return usable[self._index]

    def call_method(self, method_full_name: str, cntl: Controller,
                    request: Any, response_cls: Any = None,
                    done: Optional[Callable] = None):
        state = _SelectiveCall(self, method_full_name, cntl, request,
                               response_cls, done)
        state.issue()
        if done is None:
            with self._lock:
                chans = [u.channel for u in self._units]
            state.wait(_join_timeout_s(cntl, chans) * (self.max_retry + 1))
            return cntl.response
        return None


class _SelectiveCall:
    def __init__(self, schan, method, cntl, request, response_cls, done):
        self.schan = schan
        self.method = method
        self.cntl = cntl
        self.request = request
        self.response_cls = response_cls
        self.done = done
        self.tried: set = set()
        self.attempts = 0
        self.event = threading.Event()
        self.start_us = time.monotonic_ns() // 1000

    def issue(self) -> None:
        unit = self.schan._select(self.tried)
        if unit is None:
            self.cntl.set_failed(errors.ENODATA, "no usable sub channel")
            self._finish()
            return
        self.tried.add(unit.index)
        self.attempts += 1
        sub_cntl = Controller()
        sub_cntl.timeout_ms = self.cntl.timeout_ms
        sub_cntl.log_id = self.cntl.log_id
        # the compiled fan-out's state flows through the selection: a unit
        # that is a Parallel/Partition channel lowers the operand itself,
        # and the caller sees the route the selected unit took
        op = self.cntl.__dict__.get("fanout_operand")
        if op is not None:
            sub_cntl.fanout_operand = op
        unit.channel.call_method(
            self.method, sub_cntl, self.request, self.response_cls,
            done=lambda sc, u=unit: self._on_sub_done(u, sc))

    def _on_sub_done(self, unit: _Unit, sub_cntl: Controller) -> None:
        unit.breaker.on_call_end(sub_cntl.error_code_)
        if not sub_cntl.failed():
            self.cntl.response = sub_cntl.response
            self.cntl.remote_side = sub_cntl.remote_side
            if sub_cntl.fanout_route:
                self.cntl.fanout_route = sub_cntl.fanout_route
                self.cntl.fanout_result = sub_cntl.fanout_result
            self._finish()
            return
        # retry on a different sub-channel
        if self.attempts <= self.schan.max_retry \
                and len(self.tried) < self.schan.channel_count():
            self.cntl.retried_count += 1
            self.issue()
            return
        self.cntl.set_failed(sub_cntl.error_code_, sub_cntl.error_text_)
        self._finish()

    def wait(self, timeout_s: float) -> None:
        """Every try ends by its own deadline, well inside ``timeout_s``;
        a scheduler worker waiting here counts as blocked."""
        from ..bthread import scheduler
        scheduler.note_worker_blocked()
        try:
            if not self.event.wait(timeout_s):
                raise TimeoutError("selective call join timed out")
        finally:
            scheduler.note_worker_unblocked()

    def _finish(self) -> None:
        self.cntl.latency_us = time.monotonic_ns() // 1000 - self.start_us
        self.event.set()
        if self.done is not None:
            from ..bthread import scheduler
            scheduler.start_background(self.done, self.cntl, name="schan_done")
