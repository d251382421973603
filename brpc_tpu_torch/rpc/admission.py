"""Admission control: priority/deadline-aware shed-before-queue with
per-tenant weighted fair queueing.

Port of :mod:`brpc_tpu.rpc.admission` (reference doctrine: the
concurrency-limiter + method-status pair of docs/cn/
auto_concurrency_limiter.md, extended with the priority bands and tenant
fairness a disaggregated-serving pod needs).  The controller sits between
protocol parse and the usercode pool.  Both of the port's call planes,
``ici://`` and ``mem://``, speak tpu_std, so one gate in
``tpu_std.process_request`` treats a request the same whichever way it
arrived:

* **deadline-expired shed** — a request whose propagated
  ``deadline_left_ms`` budget is already spent is rejected before any
  work (distinct error text: executing it would be pure waste).
* **shed-before-queue** — when the concurrency gate (server
  ``max_concurrency`` / the method's limiter) says no, sheddable-band and
  over-fair-share requests are rejected IMMEDIATELY with retryable
  ``ELIMIT`` carrying ``retry_after_ms`` (from the observed service
  rate), instead of queueing until their deadline dies on the floor.
* **bounded queueing for the protected bands** — high-priority requests
  may wait up to ``max_queue_ms`` (never past their deadline budget) in
  a weighted fair queue: strict priority bands, deficit round robin
  across tenants within a band.

Shed responses are *admission* outcomes, not method failures: they are
kept out of the limiter's latency samples and the method's error count
(see ``MethodStatus.on_responded``).  A request shed here has already
crossed the transport, DEVICE attachment included (the ici transport
relocates it before the server parses the frame): the shed path recycles
the request's Controller, which drops the received tensor.
"""
from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..butil import debug_sync as _dbg
from .. import bvar
from . import errors

# distinct error texts (the shed reasons operators grep for)
SHED_DEADLINE_TEXT = "deadline budget spent before admission (shed)"
SHED_BAND_TEXT = "shed: sheddable priority band under overload"
SHED_FAIR_SHARE_TEXT = "shed: tenant over fair share of admission queue"
SHED_QUEUE_FULL_TEXT = "shed: admission queue full"
SHED_QUEUE_TIMEOUT_TEXT = "shed: admission queue wait exceeded bound"


@dataclass
class AdmissionOptions:
    """Tuning for the admission layer (``ServerOptions.admission``)."""
    bands: int = 4                   # priority 0=critical .. bands-1=sheddable
    # requests arriving without a priority land in this band
    default_priority: int = 2
    # priorities <= this may QUEUE when the gate is full; higher bands
    # shed immediately (the shed-before-queue line)
    queueable_priority_max: int = 1
    max_queue_ms: float = 50.0       # bounded queue delay per request
    queue_capacity: int = 256        # per band, across tenants
    tenant_weights: Dict[str, int] = field(default_factory=dict)
    default_tenant_weight: int = 1
    retry_after_min_ms: int = 1
    retry_after_max_ms: int = 2000
    # test hook: pin the observed service rate (req/s) instead of the
    # release-event EMA — the deterministic mini-overload test drives a
    # simulated clock and an injectable rate through this
    service_rate_override: float = 0.0
    # test hook: skip TimerThread expiry timers (simulated-clock tests
    # expire queued entries manually via expire_queued(now_us))
    use_timers: bool = True

    def tenant_weight(self, tenant: str) -> int:
        """The tenant's WFQ weight — shared policy surface: the DRR
        admission queue spends it as dequeue credit, and the serving
        KV pool's eviction order consults the SAME table
        (``serving.KvPoolOptions.from_admission``), so queue fairness
        and memory pressure agree on who absorbs overload."""
        return tenant_weight_of(self.tenant_weights,
                                self.default_tenant_weight, tenant)


def tenant_weight_of(weights: Dict[str, int], default: int,
                     tenant: str) -> int:
    """THE tenant-weight lookup (floor 1): the DRR admission queue and
    the serving KV pool's eviction order must agree on this rule, so it
    lives exactly once."""
    return max(1, weights.get(tenant, default))


def shed_backoff_s(hint_ms: int, seed=None) -> float:
    """The server's ``retry_after_ms`` hint plus 0-25 % jitter ABOVE it,
    never below: shed callers re-arriving at the same instant are the
    synchronized storm the hint exists to prevent.  ``seed`` makes the
    jitter deterministic per (call, try); None draws from the process
    generator."""
    rng = random.Random(seed) if seed is not None else random
    return hint_ms * (1.0 + 0.25 * rng.random()) / 1000.0


def server_method_gate(server, status) -> Callable[[], bool]:
    """The concurrency gate the tpu_std server path hands to submit():
    server-level max_concurrency AND the method's limiter, acquired
    atomically-enough (a method-gate refusal rolls the server count
    back via on_request_rollback — NOT on_request_out, whose admission
    release-pump would recurse right back into this gate and poison the
    service-rate EMA with phantom releases).  True = both gates held;
    the caller MUST pair with on_request_out / status.on_responded
    exactly once."""
    def try_enter() -> bool:
        if not server.on_request_in():
            return False
        if status is not None and not status.on_requested():
            server.on_request_rollback()
            return False
        return True
    return try_enter


class _Entry:
    """One queued request: claim-once arbitration between the pump
    (admit), the expiry timer (shed), and fail_all (server stopping)."""

    __slots__ = ("priority", "tenant", "enq_us", "expire_us", "run",
                 "shed", "try_enter", "claimed", "lock", "timer")

    def __init__(self, priority: int, tenant: str, enq_us: int,
                 expire_us: int, run, shed, try_enter):
        self.priority = priority
        self.tenant = tenant
        self.enq_us = enq_us
        self.expire_us = expire_us
        self.run = run
        self.shed = shed
        self.try_enter = try_enter
        self.claimed = False
        self.lock = threading.Lock()
        self.timer = None

    def claim(self) -> bool:
        with self.lock:
            if self.claimed:
                return False
            self.claimed = True
            return True


class _BandQueue:
    """Per-priority-band tenant queues + deficit-round-robin state.
    All access under the owning controller's lock."""

    __slots__ = ("tenants", "rr", "deficit", "size")

    def __init__(self):
        self.tenants: "OrderedDict[str, deque]" = OrderedDict()
        self.rr: deque = deque()         # tenant rotation order
        self.deficit: Dict[str, int] = {}
        self.size = 0

    def push(self, entry: _Entry) -> None:
        q = self.tenants.get(entry.tenant)
        if q is None:
            q = self.tenants[entry.tenant] = deque()
            self.rr.append(entry.tenant)
            self.deficit.setdefault(entry.tenant, 0)
        q.append(entry)
        self.size += 1

    def pop_drr(self, weight_of: Callable[[str], int]) -> Optional[_Entry]:
        """Deficit round robin with unit request cost: each visit tops a
        tenant's deficit up by its weight; a tenant with deficit spends
        one unit per dequeued request — over a cycle tenant t gets
        weight(t) slots (the weighted fair share)."""
        # bound: each tenant is visited at most twice before someone
        # must have enough deficit to serve (weights are >= 1)
        for _ in range(2 * len(self.rr) + 1):
            if not self.rr:
                return None
            t = self.rr[0]
            q = self.tenants.get(t)
            if not q:
                # drained tenant leaves the rotation (re-enters on push)
                self.rr.popleft()
                self.tenants.pop(t, None)
                self.deficit.pop(t, None)
                continue
            if self.deficit[t] <= 0:
                self.deficit[t] += weight_of(t)
                self.rr.rotate(-1)
                continue
            self.deficit[t] -= 1
            self.size -= 1
            return q.popleft()
        return None

    def queued_for(self, tenant: str) -> int:
        q = self.tenants.get(tenant)
        return len(q) if q is not None else 0


class AdmissionController:
    """The admission queue in front of request execution.  One per
    Server (``Server.admission``); planes call :meth:`submit` with their
    gate + continuations, the server calls :meth:`on_release` every time
    an admitted request exits (``Server.on_request_out``)."""

    _GUARDED_BY = {
        "_bands": "_lock",
        "_queued_total": "_lock",
        "_rate_ema": "_lock",
        "_last_release_us": "_lock",
        "_stopped_reason": "_lock",
        "_counters": "_counters_lock",
        "_tenant_labels": "_counters_lock",
    }


    # distinct NON-CONFIGURED tenant labels tracked in per-tenant
    # counters before new ones fold into "~other": the tenant string is
    # untrusted wire input, and a per-unique-value bvar Adder registered
    # forever would be a remote memory-exhaustion vector
    MAX_TRACKED_TENANTS = 64

    def __init__(self, server, options: Optional[AdmissionOptions] = None,
                 now_us: Optional[Callable[[], int]] = None,
                 dispatch: Optional[Callable[..., None]] = None):
        self._server = server
        self.options = options or AdmissionOptions()
        self._now_us = now_us or (lambda: time.monotonic_ns() // 1000)
        self._dispatch_override = dispatch
        self._lock = _dbg.make_lock("AdmissionController._lock")
        self._bands = [_BandQueue() for _ in range(self.options.bands)]
        self._queued_total = 0
        self._rate_ema = 0.0             # observed service rate, req/s
        self._last_release_us = 0
        self._stopped_reason: Optional[tuple] = None
        # per-(tenant, band) counters, created lazily; aggregate adders
        # are eager so /vars always shows the family
        self._counters_lock = _dbg.make_lock("AdmissionController._counters_lock")
        self._counters: Dict[tuple, bvar.Adder] = {}
        self._tenant_labels: set = set()
        self.admitted = bvar.Adder("rpc_admission_admitted")
        self.queued_admitted = bvar.Adder("rpc_admission_queued_admitted")
        self.shed_total = bvar.Adder("rpc_admission_shed")
        self.queue_wait_rec = bvar.IntRecorder("rpc_admission_queue_wait_us")

    # ---- counters -----------------------------------------------------
    def _count(self, what: str, tenant: str, band: int) -> None:
        with self._counters_lock:
            if tenant and tenant not in self.options.tenant_weights \
                    and tenant not in self._tenant_labels:
                if len(self._tenant_labels) >= self.MAX_TRACKED_TENANTS:
                    tenant = "~other"    # cardinality cap (wire input)
                else:
                    self._tenant_labels.add(tenant)
            key = (what, tenant, band)
            a = self._counters.get(key)
            if a is None:
                safe = bvar.to_underscored_name(tenant or "shared")
                a = self._counters[key] = bvar.Adder(
                    f"rpc_admission_{what}_{safe}_b{band}")
        a << 1

    # ---- the decision point -------------------------------------------
    def submit(self, *, priority: Optional[int], tenant: str,
               deadline_left_ms: Optional[int], recv_us: int,
               try_enter: Callable[[], bool],
               run: Callable[[int], None],
               shed: Callable[[int, str, int], None]) -> None:
        """Admit, queue, or shed one parsed request.

        ``try_enter`` acquires the concurrency gates (see
        server_method_gate).  ``run(queued_us)`` executes the request
        (gates held; queued_us = admission-queue wait for the rpcz
        queue-stage decomposition).  ``shed(code, text, retry_after_ms)``
        sends the rejection; the caller must NOT have entered any gate
        when it fires."""
        opts = self.options
        pri = opts.default_priority if priority is None else priority
        if pri < 0:
            pri = 0
        elif pri >= opts.bands:
            pri = opts.bands - 1
        tenant = tenant or ""
        now = self._now_us()
        # deadline-expired shed: budget spent before any work.  The
        # RESIDUAL budget (propagated deadline minus time already burned
        # since the frame was received) also caps the queue stay below —
        # queueing a request past what's left of its deadline is the
        # dead work this layer exists to avoid.
        residual_ms = None
        if deadline_left_ms is not None and deadline_left_ms > 0:
            spent_ms = (now - recv_us) / 1000.0 if recv_us else 0.0
            residual_ms = deadline_left_ms - spent_ms
            if residual_ms <= 0:
                self._count("shed_deadline", tenant, pri)
                self.shed_total << 1
                shed(errors.ERPCTIMEDOUT, SHED_DEADLINE_TEXT, 0)
                return
        if try_enter():
            self.admitted << 1
            self._count("admitted", tenant, pri)
            run(0)
            return
        # ---- gate says no: shed-before-queue --------------------------
        if pri > opts.queueable_priority_max:
            self._shed_now(shed, "shed_band", SHED_BAND_TEXT, tenant, pri)
            return
        expire_ms = opts.max_queue_ms
        if residual_ms is not None:
            expire_ms = min(expire_ms, residual_ms)
        entry = _Entry(pri, tenant, now, now + int(expire_ms * 1000),
                       run, shed, try_enter)
        stopped = None                   # (code, text) when refusing
        shed_reason = None               # (counter, text) when shedding
        with self._lock:
            if self._stopped_reason is not None:
                stopped = self._stopped_reason
            else:
                band = self._bands[pri]
                if band.size >= opts.queue_capacity:
                    shed_reason = ("shed_queue_full", SHED_QUEUE_FULL_TEXT)
                elif band.queued_for(tenant) + 1 > self._fair_share_locked(
                        band, tenant):
                    shed_reason = ("shed_fair_share", SHED_FAIR_SHARE_TEXT)
                else:
                    band.push(entry)
                    self._queued_total += 1
        if stopped is not None:
            self._count("shed_stopped", tenant, pri)
            self.shed_total << 1
            shed(stopped[0], stopped[1], 0)
            return
        if shed_reason is not None:
            self._shed_now(shed, shed_reason[0], shed_reason[1], tenant,
                           pri)
            return
        self._count("queued", tenant, pri)
        if opts.use_timers:
            from ..bthread.timer_thread import TimerThread
            entry.timer = TimerThread.instance().schedule_after(
                lambda: self._expire_entry(entry),
                max(expire_ms, 0.1) / 1000.0)
        # close the enqueue/release race: a slot may have freed between
        # the failed try_enter and the push
        self.pump()

    def _shed_now(self, shed, what: str, text: str, tenant: str,
                  pri: int) -> None:
        self._count(what, tenant, pri)
        self.shed_total << 1
        shed(errors.ELIMIT, text, self.retry_after_ms())

    def _fair_share_locked(self, band: _BandQueue, tenant: str) -> int:
        """Tenant's queued-entry cap in this band: its weighted share of
        the band capacity among the tenants currently competing there
        (itself included).  Alone, a tenant may use the whole queue;
        under contention its share shrinks to weight/total — the
        shed-on-over-share rule that keeps one tenant's burst from
        squeezing everyone else out of the protected bands."""
        w = self._weight(tenant)
        total = w
        for t in band.tenants:
            if t != tenant:
                total += self._weight(t)
        return max(1, (self.options.queue_capacity * w) // total)

    def _weight(self, tenant: str) -> int:
        return self.options.tenant_weight(tenant)

    # ---- retry-after hint ---------------------------------------------
    def service_rate(self) -> float:
        """Observed completions/s (EMA over release events), or the test
        override when pinned."""
        if self.options.service_rate_override > 0:
            return self.options.service_rate_override
        with self._lock:
            return self._rate_ema

    def retry_after_ms(self) -> int:
        """How long a shed caller should back off: the time the current
        backlog needs to drain at the observed service rate.  Always
        nonzero — a shed with no hint would invite an immediate retry
        storm at a server that just said it is saturated."""
        opts = self.options
        rate = self.service_rate()
        with self._lock:
            backlog = self._queued_total + 1
        if rate <= 0.0:
            ms = opts.max_queue_ms or 10.0
        else:
            ms = 1000.0 * backlog / rate
        return int(min(max(ms, opts.retry_after_min_ms),
                       opts.retry_after_max_ms))

    # ---- release / pump -----------------------------------------------
    def on_release(self, now_us: Optional[int] = None) -> None:
        """One admitted request exited (Server.on_request_out): record a
        service-rate sample and hand its slot to the queue head."""
        now = self._now_us() if now_us is None else now_us
        with self._lock:
            if self._last_release_us:
                dt_us = max(now - self._last_release_us, 1)
                inst = 1e6 / dt_us
                self._rate_ema = (inst if self._rate_ema == 0.0
                                  else 0.9 * self._rate_ema + 0.1 * inst)
            self._last_release_us = now
            empty = self._queued_total == 0
        if not empty:
            self.pump()

    def pump(self, now_us: Optional[int] = None) -> int:
        """Move queued requests into free concurrency slots: strict
        priority order across bands, DRR across tenants within one.
        Returns the number dispatched.  An entry whose gate refuses is
        put back at its tenant's queue head (the slot the release freed
        went to a racing arrival; the entry keeps its place and
        expiry)."""
        dispatched = 0
        now = self._now_us() if now_us is None else now_us
        while True:
            entry = None
            with self._lock:
                for band in self._bands:
                    while band.size:
                        e = band.pop_drr(self._weight)
                        if e is None:
                            break
                        self._queued_total -= 1
                        if not e.claim():
                            continue         # expired/failed concurrently
                        entry = e
                        break
                    if entry is not None:
                        break
            if entry is None:
                return dispatched
            if now >= entry.expire_us:
                self._finish_timer(entry)
                self._count("shed_queue_timeout", entry.tenant,
                            entry.priority)
                self.shed_total << 1
                entry.shed(errors.ELIMIT, SHED_QUEUE_TIMEOUT_TEXT,
                           self.retry_after_ms())
                continue
            if not entry.try_enter():
                # no free slot after all: restore the entry (unclaimed)
                # at its tenant's queue head, keeping FIFO order — unless
                # the controller stopped meanwhile, then bounce it
                with entry.lock:
                    entry.claimed = False
                stopped = None
                with self._lock:
                    stopped = self._stopped_reason
                    if stopped is None:
                        band = self._bands[entry.priority]
                        q = band.tenants.get(entry.tenant)
                        if q is not None:
                            q.appendleft(entry)
                            band.size += 1
                        else:
                            band.push(entry)
                        self._queued_total += 1
                if stopped is not None and entry.claim():
                    self._finish_timer(entry)
                    self._count("shed_stopped", entry.tenant,
                                entry.priority)
                    self.shed_total << 1
                    entry.shed(stopped[0], stopped[1], 0)
                return dispatched
            self._finish_timer(entry)
            waited_us = max(now - entry.enq_us, 0)
            self.queue_wait_rec << waited_us
            self.queued_admitted << 1
            self.admitted << 1
            self._count("admitted", entry.tenant, entry.priority)
            self._dispatch(entry, waited_us)
            dispatched += 1

    def _dispatch(self, entry: _Entry, waited_us: int) -> None:
        """Run an admitted-from-queue entry OFF the releasing thread
        (the pump fires inside a finishing request's completion path —
        running user code there would recurse under sustained load).
        usercode_in_pthread servers keep their pool isolation: queued
        continuations re-enter through the backup pool with the queued
        counter held, exactly like InputMessenger dispatch."""
        if self._dispatch_override is not None:
            self._dispatch_override(entry.run, waited_us)
            return
        server = self._server
        pool = getattr(server, "usercode_pool", None) \
            if server is not None else None
        if pool is not None:
            server.on_usercode_queued()
            try:
                pool.submit(self._run_pooled, entry, waited_us)
                return
            except RuntimeError:
                server.on_usercode_done()
        from ..bthread import scheduler
        scheduler.start_background(entry.run, waited_us,
                                   name="admission_admit")

    def _run_pooled(self, entry: _Entry, waited_us: int) -> None:
        try:
            entry.run(waited_us)
        finally:
            self._server.on_usercode_done()

    @staticmethod
    def _finish_timer(entry: _Entry) -> None:
        if entry.timer is not None:
            from ..bthread.timer_thread import TimerThread
            TimerThread.instance().unschedule(entry.timer)
            entry.timer = None

    def _expire_entry(self, entry: _Entry) -> None:
        """TimerThread callback: the bounded queue delay elapsed.  The
        shed continuation itself (a full response encode + a possibly
        blocking socket.write on the wire plane) runs on a tasklet, not
        here — one slow unread client connection must never stall the
        process-wide timer heap every RPC deadline rides on."""
        if not entry.claim():
            return
        self._remove_entry(entry)
        self._count("shed_queue_timeout", entry.tenant, entry.priority)
        self.shed_total << 1
        ra = self.retry_after_ms()
        from ..bthread import scheduler
        scheduler.start_background(entry.shed, errors.ELIMIT,
                                   SHED_QUEUE_TIMEOUT_TEXT, ra,
                                   name="admission_shed")

    def _remove_entry(self, entry: _Entry) -> None:
        with self._lock:
            band = self._bands[entry.priority]
            q = band.tenants.get(entry.tenant)
            if q is not None:
                try:
                    q.remove(entry)
                    band.size -= 1
                    self._queued_total -= 1
                except ValueError:
                    pass                  # already popped by a pump

    def expire_queued(self, now_us: Optional[int] = None) -> int:
        """Shed every queued entry whose bound has passed (simulated-
        clock test surface; the wall-clock path uses per-entry timers).
        Returns the number shed."""
        now = self._now_us() if now_us is None else now_us
        expired = []
        with self._lock:
            for band in self._bands:
                for q in band.tenants.values():
                    for e in list(q):
                        if now >= e.expire_us and e.claim():
                            q.remove(e)
                            band.size -= 1
                            self._queued_total -= 1
                            expired.append(e)
        for e in expired:
            self._finish_timer(e)
            self._count("shed_queue_timeout", e.tenant, e.priority)
            self.shed_total << 1
            e.shed(errors.ELIMIT, SHED_QUEUE_TIMEOUT_TEXT,
                   self.retry_after_ms())
        return len(expired)

    # ---- lifecycle ----------------------------------------------------
    def fail_all(self, code: int, text: str) -> int:
        """Server stopping/draining: claim and shed every queued entry
        (retryable ELOGOFF — the lame-duck bounce) and refuse later
        enqueues with the same code until reset."""
        with self._lock:
            self._stopped_reason = (code, text)
            victims = []
            for band in self._bands:
                for q in band.tenants.values():
                    victims.extend(q)
                band.tenants.clear()
                band.rr.clear()
                band.deficit.clear()
                band.size = 0
            self._queued_total = 0
        n = 0
        for e in victims:
            if e.claim():
                self._finish_timer(e)
                self._count("shed_stopped", e.tenant, e.priority)
                self.shed_total << 1
                e.shed(code, text, 0)
                n += 1
        return n

    def reset(self) -> None:
        """Lift the stopped/draining refusal (server restart)."""
        with self._lock:
            self._stopped_reason = None

    def queued(self) -> int:
        with self._lock:
            return self._queued_total

    def describe(self) -> dict:
        """The /status block: aggregate + per-(tenant, band) counters."""
        with self._counters_lock:
            per = {f"{what}[{tenant or 'shared'}][b{band}]": a.get_value()
                   for (what, tenant, band), a in self._counters.items()}
        with self._lock:
            queued = self._queued_total
            rate = (self.options.service_rate_override
                    or self._rate_ema)
        return {
            "queued": queued,
            "admitted": self.admitted.get_value(),
            "admitted_from_queue": self.queued_admitted.get_value(),
            "shed": self.shed_total.get_value(),
            "service_rate_rps": round(rate, 1),
            "retry_after_ms": self.retry_after_ms(),
            "by_tenant_band": per,
        }
