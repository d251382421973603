"""ParallelChannel: fan one RPC out to N sub-channels concurrently.

Reference: src/brpc/parallel_channel.{h,cpp} (CallMethod :551, CallMapper::Map
:94-107, ResponseMerger::Merge :127-144), ported from
:mod:`brpc_tpu.channels.parallel_channel`.  Semantics kept:

  * CallMapper rewrites the request per sub-channel (replicate by default;
    shard for scatter patterns) and may skip a sub-channel.  Its SubCall
    may carry a request attachment: bytes, or an IOBuf holding a DEVICE
    shard, which crosses an ``ici://`` sub-channel on the device plane.
  * ResponseMerger folds each arriving sub-response into the caller's
    response (called serially, in arrival order, under the parent's
    lock); a merger with ``merge_sub`` sees the sub-call's index and
    controller (its response attachment) instead, and one with
    ``finalize_fanout`` runs once when the whole fan-out succeeded.
  * fail_limit: the call fails once that many sub-calls failed
    (ETOOMANYFAILS); success completes when every non-skipped sub-call ends.

A call with ``cntl.fanout_operand`` set first tries the compiled route
(:func:`.collective_fanout.maybe_call`): when every member is an
``ici://`` rank whose server registered a device-side body for the method
and the mappers and mergers lower, the whole fan-out and its merge run on
the mesh; otherwise, or when that attempt fails mid-call, the call takes
the RPC loop, a sub-call per member, with the mappers' ``map_fanout``
carrying the operand.  A PartitionChannel reaches the hook through this
method too.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ..butil.iobuf import IOBuf
from ..rpc import errors
from ..rpc.controller import Controller


class SubCall:
    """What CallMapper returns for one sub-channel.  ``attachment``, when
    set, becomes the sub-call's request attachment (bytes or an IOBuf)."""
    __slots__ = ("request", "skip", "attachment")

    def __init__(self, request: Any = None, skip: bool = False,
                 attachment: Any = None):
        self.request = request
        self.skip = skip
        self.attachment = attachment

    @staticmethod
    def skip_call() -> "SubCall":
        return SubCall(skip=True)


class CallMapper:
    def map(self, channel_index: int, method_full_name: str,
            request: Any) -> SubCall:
        return SubCall(request)             # default: replicate


class ResponseMerger:
    MERGED = 0
    FAIL = 1
    FAIL_ALL = 2

    def merge(self, response: Any, sub_response: Any) -> int:
        """Fold sub_response into response; default: protobuf MergeFrom.
        Mergers may instead implement ``merge_sub(parent_cntl, index,
        sub_cntl, response)``, and ``finalize_fanout(parent_cntl)``, run
        once when the whole fan-out succeeded."""
        if response is not None and hasattr(response, "MergeFrom"):
            response.MergeFrom(sub_response)
        return self.MERGED


class ParallelChannel:
    def __init__(self, fail_limit: int = -1):
        self._subs: List = []               # (channel, mapper, merger)
        self.fail_limit = fail_limit

    def add_channel(self, channel, mapper: Optional[CallMapper] = None,
                    merger: Optional[ResponseMerger] = None) -> int:
        self._subs.append((channel, mapper or CallMapper(),
                           merger or ResponseMerger()))
        return 0

    def channel_count(self) -> int:
        return len(self._subs)

    def call_method(self, method_full_name: str, cntl: Controller,
                    request: Any, response: Any = None,
                    done: Optional[Callable[[Controller], None]] = None):
        """Sync when done is None (returns ``response``); async
        otherwise."""
        n = len(self._subs)
        if n == 0:
            cntl.set_failed(errors.EINVAL, "no sub channels")
            if done:
                done(cntl)
            return None
        # the compiled collective route; a failure inside it falls through
        # to the per-member loop below, the route already marked down
        from . import collective_fanout as _cf
        if _cf.maybe_call(self, method_full_name, cntl, request, response,
                          done):
            return response if done is None else None
        fail_limit = self.fail_limit if self.fail_limit > 0 else n
        finalizer = next((m for _, _, m in self._subs
                          if hasattr(m, "finalize_fanout")), None)
        operand = cntl.__dict__.get("fanout_operand") is not None
        if operand:
            _cf.note_loop_devices(self._subs, cntl)
        state = _ParallelCallState(cntl, response, n, fail_limit, done,
                                   finalizer=finalizer)
        cntl._start_us = time.monotonic_ns() // 1000
        response_cls = type(response) if response is not None else None
        for i, (chan, mapper, merger) in enumerate(self._subs):
            try:
                mf = getattr(mapper, "map_fanout", None) if operand else None
                if mf is not None:
                    sub = mf(i, method_full_name, request, cntl)
                else:
                    sub = mapper.map(i, method_full_name, request)
            except Exception as e:
                # a raising mapper fails its sub-call, not the issue loop
                bad = Controller()
                bad.set_failed(errors.EREQUEST,
                               f"CallMapper failed for sub {i}: {e}")
                state.on_sub_done(i, merger, bad)
                continue
            if sub.skip:
                state.on_skip()
                continue
            sub_cntl = Controller()
            if sub.attachment is not None:
                sub_cntl.request_attachment.append(
                    sub.attachment if isinstance(sub.attachment, IOBuf)
                    else bytes(sub.attachment))
            sub_cntl.timeout_ms = cntl.timeout_ms
            sub_cntl.max_retry = cntl.max_retry
            sub_cntl.log_id = cntl.log_id
            chan.call_method(
                method_full_name, sub_cntl, sub.request, response_cls,
                done=lambda sc, idx=i, m=merger: state.on_sub_done(idx, m, sc))
        if done is None:
            state.wait(_join_timeout_s(cntl, (c for c, _, _ in self._subs)))
            return response
        return None


def _join_timeout_s(cntl: Controller, channels) -> float:
    """How long a sync combo call may wait for its sub-calls: the longest
    of its own and its channels' deadlines, plus the margin a sync
    ``Channel.call_method`` gives its own join."""
    ms = [cntl.timeout_ms or 0] + [
        getattr(getattr(c, "options", None), "timeout_ms", 0) or 0
        for c in channels]
    return max(ms) / 1000.0 + 35.0


class _ParallelCallState:
    def __init__(self, cntl: Controller, response: Any, total: int,
                 fail_limit: int, done, finalizer=None):
        self.cntl = cntl
        self.response = response
        self.total = total
        self.fail_limit = fail_limit
        self.done = done
        self.lock = threading.Lock()
        self.finished = 0
        self.failed = 0
        self.skipped = 0
        self.ended = False
        self.event = threading.Event()
        self.sub_errors: List[int] = []
        self.finalizer = finalizer

    def on_skip(self) -> None:
        with self.lock:
            self.total -= 1
            self.skipped += 1
            if self.finished >= self.total:
                self._maybe_end_locked()

    def on_sub_done(self, index: int, merger: ResponseMerger,
                    sub_cntl: Controller) -> None:
        with self.lock:
            if self.ended:
                return
            self.finished += 1
            if sub_cntl.failed():
                self.failed += 1
                self.sub_errors.append(sub_cntl.error_code_)
            else:
                try:
                    ms = getattr(merger, "merge_sub", None)
                    if ms is not None:
                        rc = ms(self.cntl, index, sub_cntl, self.response)
                    else:
                        rc = merger.merge(self.response, sub_cntl.response)
                except Exception as e:
                    from ..butil import logging as log
                    log.warning("fan-out merge failed for sub %d: %s",
                                index, e)
                    rc = ResponseMerger.FAIL
                if rc == ResponseMerger.FAIL:
                    self.failed += 1
                    self.sub_errors.append(errors.ERESPONSE)
                elif rc == ResponseMerger.FAIL_ALL:
                    self.failed = self.fail_limit
            self._maybe_end_locked()

    def _maybe_end_locked(self) -> None:
        if self.ended:
            return
        if self.failed >= self.fail_limit:
            self.cntl.set_failed(
                errors.ETOOMANYFAILS,
                f"{self.failed}/{self.total} sub-calls failed: "
                f"{self.sub_errors[:4]}")
            self._end_locked()
        elif self.finished >= self.total:
            self._end_locked()

    def _end_locked(self) -> None:
        self.ended = True
        if self.finalizer is not None and not self.cntl.failed():
            if self.failed or self.skipped:
                # an index-merged result missing a shard is wrong data,
                # not a partial success
                self.cntl.set_failed(
                    errors.ERESPONSE,
                    f"fan-out merge incomplete: {self.failed} failed / "
                    f"{self.skipped} skipped sub-call(s) before merge: "
                    f"{self.sub_errors[:4]}")
            else:
                try:
                    self.finalizer.finalize_fanout(self.cntl)
                except Exception as e:
                    self.cntl.set_failed(errors.ERESPONSE,
                                         f"fan-out finalize failed: {e}")
        self.cntl.latency_us = (time.monotonic_ns() // 1000
                                - self.cntl._start_us)
        self.cntl.response = self.response
        self.event.set()
        if self.done is not None:
            from ..bthread import scheduler
            scheduler.start_background(self.done, self.cntl,
                                       name="pchan_done")

    def wait(self, timeout_s: float) -> None:
        """Every sub-call ends by its own deadline, well inside
        ``timeout_s``; a scheduler worker waiting here counts as
        blocked."""
        from ..bthread import scheduler
        scheduler.note_worker_blocked()
        try:
            if not self.event.wait(timeout_s):
                raise TimeoutError("fan-out join timed out")
        finally:
            scheduler.note_worker_unblocked()
