"""Continuous-batching decode scheduler: ONE batched step per tick over the
active session set, sessions admitted and retired BETWEEN steps.

Port of :mod:`brpc_tpu.serving.scheduler`.  Decode is a step loop:

  * **per-step admit/evict** — before every step the scheduler admits
    pending sessions into the roster (strict priority-band order) up to
    ``max_batch``, retires sessions that produced their requested tokens,
    fails queued sessions whose deadline died waiting, and — when an
    INTERACTIVE session is pending and the roster is full of batch-band
    work — PREEMPTS the most sheddable active session (its progress is
    kept; it resumes from its next token when a slot frees, bit-exact);
  * **one batched step** — the whole roster advances one token with one
    gather through the paged pool's block tables into the per-token
    reduction arena plus a handful of elementwise ops: ONE function of
    tensors on the pool's device (:func:`step_tokens`).
    The block table and roster tensors are rebuilt only when the roster
    changes; the step syncs with the host once, in ``tolist()``;
  * **pins** — every rostered session is pinned in the pool for exactly
    the steps it spends in the roster.

Completion callbacks (``emit``/``fail``) run ON the step thread.  The loop
thread starts lazily on first submit and parks on its condvar when idle;
``stop()`` fails everything queued and joins it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import bvar
from ..rpc import errors
from .kv_pool import BANDS, DEFAULT_PRIORITY, PagedKvPool

# bands <= this are "interactive": they may preempt batch-band sessions
# out of a full roster (progress preserved)
INTERACTIVE_PRIORITY_MAX = 1


@dataclass
class BatchSchedulerOptions:
    vocab: int                       # the decode recurrence's modulus
    max_batch: int = 64
    # False: no step thread — tests drive step_once() deterministically
    auto_start: bool = True


class StepRequest:
    """One decode request: produce ``steps`` tokens for ``session``.

    Mutable progress (``prev``/``stepi``/``tokens``) lives here so a
    preempted session resumes exactly where it stopped.  ``emit(tokens)``
    / ``fail(code, text, retry_after_ms)`` fire exactly once, on the
    step thread."""

    __slots__ = ("session", "steps", "priority", "tenant", "deadline_us",
                 "emit", "fail", "enq_us", "prev", "stepi", "tokens",
                 "kv")

    def __init__(self, session: str, steps: int,
                 emit: Callable[[List[int]], None],
                 fail: Callable[[int, str, int], None],
                 priority: Optional[int] = None, tenant: str = "",
                 deadline_us: Optional[int] = None):
        self.session = session
        self.steps = steps
        self.priority = priority
        self.tenant = tenant
        self.deadline_us = deadline_us
        self.emit = emit
        self.fail = fail
        self.enq_us = 0
        self.prev = 0                # resumes carry the live recurrence
        self.stepi = 0
        self.tokens: List[int] = []
        self.kv = None               # _KvSession while rostered


def step_tokens(pos_flat: torch.Tensor, tbl: torch.Tensor, seq: torch.Tensor,
                acc: torch.Tensor, prev: torch.Tensor, stepi: torch.Tensor,
                block_tokens: int, vocab: int) -> torch.Tensor:
    """The per-step decode recurrence over the whole roster, int64 tensors
    on one device: one gather through the block tables into the pool's
    reduction arena plus elementwise ops (the toy model's reference
    decode, token for token)."""
    pos = torch.remainder(prev + stepi, seq)
    blk = torch.gather(tbl, 1, torch.div(pos, block_tokens,
                                         rounding_mode="floor")[:, None])[:, 0]
    read = pos_flat[blk * block_tokens + torch.remainder(pos, block_tokens)]
    return torch.remainder(acc + read * (stepi + 1) + prev * 31, vocab)


class ContinuousBatchScheduler:
    """Admit → step → retire, forever.  One per decode worker; its step
    runs on the pool's device."""

    def __init__(self, pool: PagedKvPool,
                 options: BatchSchedulerOptions,
                 now_us: Optional[Callable[[], int]] = None):
        self.pool = pool
        self.options = options
        self._now_us = now_us or (lambda: time.monotonic_ns() // 1000)
        self._cv = threading.Condition()
        self._pending: List[deque] = [deque() for _ in range(BANDS)]
        self._active: List[StepRequest] = []     # roster, admit order
        # sessions currently owned by the scheduler (pending OR
        # rostered): a duplicate submit is refused, since two roster
        # entries on one session would let the first completion release
        # blocks the second still gathers through
        self._owned: set = set()
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        # roster tensors on the pool's device (step-thread-owned; rebuilt
        # when the roster changes membership)
        self._dirty = True
        self._tbl = self._seq = self._acc = None
        self._prev = self._stepi = None
        self.steps = bvar.Adder("serving_steps")
        self.tokens_out = bvar.Adder("serving_tokens")
        self.admitted = bvar.Adder("serving_admitted")
        self.retired = bvar.Adder("serving_retired")
        self.preempted = bvar.Adder("serving_preempted")
        self.expired = bvar.Adder("serving_deadline_expired")
        self.rejected = bvar.Adder("serving_rejected")
        self.occupancy = bvar.IntRecorder("serving_batch_occupancy")
        self._rate_lock = threading.Lock()
        self._rate_ema = 0.0         # steps/s EMA
        self._last_step_us = 0

    # ---- submission -----------------------------------------------------
    def submit(self, req: StepRequest) -> None:
        """Queue one decode request.  Admission happens at the next step
        boundary; refusal paths fire ``req.fail`` (on this thread when
        the scheduler is stopping, on the step thread otherwise)."""
        pri = DEFAULT_PRIORITY if req.priority is None else req.priority
        pri = min(max(pri, 0), BANDS - 1)
        req.priority = pri
        req.enq_us = self._now_us()
        duplicate = False
        with self._cv:
            if self._stopping:
                stopped = True
            elif req.session in self._owned:
                stopped = False
                duplicate = True
            else:
                stopped = False
                self._owned.add(req.session)
                self._pending[pri].append(req)
                if self.options.auto_start and self._thread is None:
                    t = threading.Thread(target=self._run,
                                         name="serving_step_loop",
                                         daemon=True)
                    self._thread = t
                    t.start()
                self._cv.notify()
        if stopped:
            self.rejected << 1
            self._safe_fail(req, errors.ELOGOFF,
                            "decode scheduler stopping", 0)
        elif duplicate:
            self.rejected << 1
            self._safe_fail(req, errors.EREQUEST,
                            f"session {req.session!r} is already "
                            "decoding (duplicate submit refused)", 0)

    # ---- the loop -------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while (not self._stopping
                       and not self._active
                       and not any(self._pending)):
                    self._cv.wait()
                if self._stopping:
                    victims = self._drain_locked()
                    break
            try:
                self.step_once()
            except Exception as e:
                # one bad roster must not wedge the worker forever: fail
                # the CURRENT roster and keep the loop alive
                from ..butil import logging as log
                log.error("serving: batched step failed", exc_info=True)
                with self._cv:
                    crashed = self._active
                    self._active = []
                    for req in crashed:
                        self._owned.discard(req.session)
                    self._dirty = True
                for req in crashed:
                    self.pool.unpin(req.session)
                    self._safe_fail(
                        req, errors.EINTERNAL,
                        f"batched decode step failed: "
                        f"{type(e).__name__}: {e}", 0)
        for req, (code, text) in victims:
            self._safe_fail(req, code, text, 0)

    def _drain_locked(self):
        victims = []
        for band in self._pending:
            while band:
                victims.append((band.popleft(),
                                (errors.ELOGOFF,
                                 "decode scheduler stopping")))
        for req in self._active:
            self.pool.unpin(req.session)
            victims.append((req, (errors.ELOGOFF,
                                  "decode scheduler stopping")))
        self._active = []
        self._owned.clear()
        self._dirty = True
        return victims

    def step_once(self) -> int:
        """Admit/evict at the boundary, then run ONE batched step over the
        roster.  Returns the roster size stepped (0 = idle).  The test
        surface for ``auto_start=False``; the loop thread calls exactly
        this."""
        with self._cv:
            admit_events = self._admit_locked()
            for req, _code, _text, _hint in admit_events:
                self._owned.discard(req.session)
            roster = list(self._active)
        for req, code, text, hint in admit_events:
            self._safe_fail(req, code, text, hint)
        if not roster:
            return 0
        self._step_roster(roster)
        finished = [r for r in roster if len(r.tokens) >= r.steps]
        if finished:
            with self._cv:
                for req in finished:
                    if req in self._active:
                        self._active.remove(req)
                    self._owned.discard(req.session)
                self._dirty = True
            for req in finished:
                self.pool.unpin(req.session)
                self.retired << 1
                self._safe_emit(req)
        self.steps << 1
        self.occupancy << len(roster)
        now = self._now_us()
        with self._rate_lock:
            if self._last_step_us:
                dt = max(now - self._last_step_us, 1)
                inst = 1e6 / dt
                self._rate_ema = (inst if self._rate_ema == 0.0
                                  else 0.98 * self._rate_ema + 0.02 * inst)
            self._last_step_us = now
        return len(roster)

    def _admit_locked(self):
        """Fill the roster from the band queues (strict priority order),
        expire dead deadlines, preempt batch work for interactive
        arrivals.  Returns [(req, code, text, retry_after)] refusals to
        fire outside the lock."""
        o = self.options
        refusals = []
        now = self._now_us()
        for band in self._pending:
            kept = None
            while band:
                req = band.popleft()
                if req.deadline_us is not None and now >= req.deadline_us:
                    self.expired << 1
                    refusals.append((req, errors.ERPCTIMEDOUT,
                                     "decode deadline expired in batch "
                                     "queue", 0))
                    continue
                if len(self._active) >= o.max_batch:
                    kept = req
                    break
                code_text = self._roster_add(req)
                if code_text is not None:
                    refusals.append((req, *code_text))
            if kept is not None:
                band.appendleft(kept)
                break
        while (len(self._active) >= o.max_batch
               and self._interactive_waiting_locked()):
            victim = self._pick_preempt_locked()
            if victim is None:
                break
            self._active.remove(victim)
            self._dirty = True
            self.pool.unpin(victim.session)
            victim.kv = None
            self._pending[victim.priority].appendleft(victim)
            self.preempted << 1
            nxt = self._pop_interactive_locked(now, refusals)
            if nxt is None:
                break
            code_text = self._roster_add(nxt)
            if code_text is not None:
                refusals.append((nxt, *code_text))
        return refusals

    def _roster_add(self, req: StepRequest):
        """Pin + roster one admitted request; returns (code, text, hint)
        on refusal, None on success."""
        kv = self.pool.get(req.session)
        if kv is None or not self.pool.pin(req.session):
            reason = self.pool.evicted_reason(req.session)
            self.rejected << 1
            if reason is not None:
                return (errors.ELIMIT,
                        f"kv {reason}-evicted: re-prefill the session", 1)
            return (errors.EREQUEST, f"unknown session {req.session!r}", 0)
        req.kv = kv
        if not req.tokens and req.stepi == 0:
            req.prev = kv.last_token          # fresh admit
        self._active.append(req)
        self._dirty = True
        self.admitted << 1
        return None

    def _interactive_waiting_locked(self) -> bool:
        return any(self._pending[b]
                   for b in range(INTERACTIVE_PRIORITY_MAX + 1))

    def _pop_interactive_locked(self, now, refusals):
        for b in range(INTERACTIVE_PRIORITY_MAX + 1):
            while self._pending[b]:
                req = self._pending[b].popleft()
                if req.deadline_us is not None and now >= req.deadline_us:
                    self.expired << 1
                    refusals.append((req, errors.ERPCTIMEDOUT,
                                     "decode deadline expired in batch "
                                     "queue", 0))
                    continue
                return req
        return None

    def _pick_preempt_locked(self):
        best = None
        for req in self._active:
            if req.priority <= INTERACTIVE_PRIORITY_MAX:
                continue
            if best is None or (req.priority, req.enq_us) > \
                    (best.priority, best.enq_us):
                best = req
        return best

    # ---- the batched step ----------------------------------------------
    def _step_roster(self, roster: List[StepRequest]) -> None:
        if self._dirty or self._tbl is None \
                or self._tbl.shape[0] != len(roster):
            self._build_tensors(roster)
            self._dirty = False
        prev = step_tokens(self.pool.pos_sums_flat, self._tbl, self._seq,
                           self._acc, self._prev, self._stepi,
                           self.pool.options.block_tokens,
                           self.options.vocab)
        self._prev = prev
        self._stepi += 1
        toks = prev.tolist()                 # the step's one host sync
        for k, req in enumerate(roster):
            req.tokens.append(toks[k])
            req.prev = toks[k]
            req.stepi += 1
        self.tokens_out << len(roster)

    def _build_tensors(self, roster: List[StepRequest]) -> None:
        # r.kv.blocks may be PREFIX-SHARED: two rostered sessions gather
        # through the SAME physical blocks — correct by construction (the
        # gather only reads), and each roster pin keeps them alive
        maxb = max(len(r.kv.blocks) for r in roster)
        tbl = np.zeros((len(roster), maxb), np.int64)
        for k, r in enumerate(roster):
            tbl[k, :len(r.kv.blocks)] = r.kv.blocks
        cols = np.array([[r.kv.seq_len, r.kv.acc, r.prev, r.stepi]
                         for r in roster], np.int64)
        dev = self.pool.device
        self._tbl = torch.from_numpy(tbl).to(dev)
        seq, acc, prev, stepi = torch.from_numpy(cols).to(dev).unbind(1)
        self._seq, self._acc = seq, acc
        self._prev, self._stepi = prev.clone(), stepi.clone()

    # ---- completion plumbing -------------------------------------------
    def _safe_emit(self, req: StepRequest) -> None:
        try:
            req.emit(req.tokens)
        except Exception:
            from ..butil import logging as log
            log.error("serving: emit for session %s failed",
                      req.session, exc_info=True)

    def _safe_fail(self, req: StepRequest, code: int, text: str,
                   retry_after_ms: int) -> None:
        try:
            req.fail(code, text, retry_after_ms)
        except Exception:
            from ..butil import logging as log
            log.error("serving: fail for session %s failed",
                      req.session, exc_info=True)

    # ---- lifecycle / observability --------------------------------------
    def stop(self) -> None:
        """Fail everything queued/active and join the step thread."""
        with self._cv:
            self._stopping = True
            t = self._thread
            self._thread = None
            self._cv.notify_all()
        if t is not None and t is not threading.current_thread():
            t.join(5.0)
        else:
            with self._cv:
                victims = self._drain_locked()
            for req, (code, text) in victims:
                self._safe_fail(req, code, text, 0)

    def owns(self, session: str) -> bool:
        """True while this scheduler holds the session (pending or
        rostered): the migration fence — a session mid-decode must not cut
        over under its running batched step."""
        with self._cv:
            return session in self._owned

    def queued(self) -> int:
        with self._cv:
            return sum(len(b) for b in self._pending)

    def active(self) -> int:
        with self._cv:
            return len(self._active)

    def step_rate(self) -> float:
        with self._rate_lock:
            return self._rate_ema

    def roster_tensors(self):
        """The step's current roster tensors (block table, seq, acc,
        prev, stepi): what a caller checks the device of."""
        return (self._tbl, self._seq, self._acc, self._prev, self._stepi)

    def describe(self) -> dict:
        """The /status serving block's scheduler half."""
        with self._cv:
            active = len(self._active)
            pending = [len(b) for b in self._pending]
        return {
            "active": active,
            "pending_by_band": pending,
            "max_batch": self.options.max_batch,
            "steps": self.steps.get_value(),
            "step_rate_hz": round(self.step_rate(), 1),
            "tokens": self.tokens_out.get_value(),
            "batch_occupancy_avg": round(self.occupancy.average(), 2),
            "admitted": self.admitted.get_value(),
            "retired": self.retired.get_value(),
            "preempted": self.preempted.get_value(),
            "deadline_expired": self.expired.get_value(),
            "rejected": self.rejected.get_value(),
            "device": str(self.pool.device),
        }
