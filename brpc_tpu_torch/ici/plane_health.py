"""One plane-health state machine for every plane of the port.

Port of :mod:`brpc_tpu.ici.plane_health`.  A plane registers a
:class:`PlaneHealth` record (:func:`register_plane`) and keeps its own
mechanics; the record owns:

  * the transitions ``UP -> DOWN(reason) -> [REESTABLISHING ->] UP`` and
    the one-transition-one-count discipline behind the ``<plane>_{down,
    reprobe,revived,ramp}`` counters (:mod:`.route`);
  * the revival policy, one of three, chosen by what the plane registers:

      ``prober``     the threaded revival (the fabric's bulk conn and shm
                     ring): :meth:`kick` starts at most one background
                     loop, which sleeps a backoff with seeded jitter
                     (doubling to a cap) before each attempt, counts a
                     ``reprobe`` per attempt and calls the plane's
                     one-attempt prober until the plane's attach path
                     reports :meth:`revived`.  ``wanted`` and ``running``
                     are decided under one hold of the plane's lock, so a
                     kick can never fall into the gap where a finishing
                     loop has decided to exit.  The loop exits on attach,
                     when nothing is wanted, or when the plane's ``dead``
                     says the socket is gone;

      ``retry_s``    the timer latch (the KV pool's host tier ``spill``,
                     live migration ``migrate``): ``mark_down`` arms a
                     re-probe deadline; the first :meth:`usable` after it
                     lapses revives the plane optimistically, and the
                     next failure re-latches.  A ``mark_down`` while down
                     re-arms the deadline without a second ``down``
                     count;
      ``epoch_fn``   the epoch gate (the collective fan-out): revival
                     when the membership epoch moved past the one
                     recorded at the degrade, or, for
                     ``transient_reasons`` only, after ``reprobe_s``
                     seconds (one bad execution must not degrade the
                     route forever under stable membership);

  * the ramp: a revival arms ``half_open``; the first :meth:`usable`
    under real traffic closes it and counts ``ramp``;
  * the hook: ``events(event, reason)`` for the ``degraded``/``revived``
    transitions (the fan-out feeds its ``collective_*`` counters and its
    log lines from it).

The lock is the plane's own (``lock=``), so the health flags commute
with the plane's handle swap; ``attached()`` runs with it held, every
other callback outside it.  ``probe(nbytes)`` is the plane's capability
check (a ring the payload fits, a live native conn) and ``gate()`` says
whether this end revives at all (the fabric's client side).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple

from . import route as _route

UP = "up"
DOWN = "down"
REESTABLISHING = "reestablishing"


class PlaneHealth:
    """One plane's health record.  All mutable state is guarded by the
    plane-supplied ``lock``; counters and hooks run outside it."""

    def __init__(self, name: str, lock, *,
                 probe: Optional[Callable[[int], bool]] = None,
                 gate: Optional[Callable[[], bool]] = None,
                 prober: Optional[Callable[[], bool]] = None,
                 attached: Optional[Callable[[], bool]] = None,
                 dead: Optional[Callable[[], bool]] = None,
                 thread_name: str = "plane_revive",
                 seed: int = 0,
                 backoff_base: float = 0.05, backoff_cap: float = 1.0,
                 retry_s: Optional[Callable[[], float]] = None,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 transient_reasons: Tuple[str, ...] = (),
                 reprobe_s: Optional[Callable[[], float]] = None,
                 events: Optional[Callable[[str, str], None]] = None):
        if sum(x is not None for x in (prober, retry_s, epoch_fn)) != 1:
            raise TypeError("a plane registers exactly one revival "
                            "policy: prober, retry_s or epoch_fn")
        if prober is not None and attached is None:
            raise TypeError("a prober plane registers attached()")
        self.name = name
        self._lock = lock
        self._probe = probe
        self._gate = gate
        self._prober = prober
        self._attached = attached
        self._dead = dead
        self._thread_name = thread_name
        self._seed = seed
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        self._retry_s = retry_s
        self._epoch_fn = epoch_fn
        self._transient_reasons = tuple(transient_reasons)
        self._reprobe_s = reprobe_s
        self._events = events
        self.state = UP
        self.reason = ""
        self.down_at = 0.0
        self.down_epoch = -1
        self.down_until = 0.0        # timer policy: 0 = up
        self.half_open = False       # revived, not yet ramped by traffic
        self.wanted = False          # prober policy: revival requested
        self.running = False         # prober policy: one loop is up
        self.probe_failures = 0      # consecutive failed revival attempts
        self.downs = 0
        self.revivals = 0

    # ---- degrade -------------------------------------------------------
    def mark_down(self, reason: str) -> bool:
        """Record the DOWN transition.  True when THIS call did it (and
        counted it); False when the plane was already down, in which case
        only the re-probe deadline is re-armed."""
        now = time.monotonic()
        with self._lock:
            if self._retry_s is not None:
                first = not self.down_until > now
                self.down_until = now + float(self._retry_s())
            else:
                first = self.state == UP
            self.reason = reason
            if not first:
                return False
            self.state = DOWN
            self.down_at = now
            self.half_open = False
            if self._epoch_fn is not None:
                # under the lock: the epoch recorded never postdates a
                # move a racing usable() already revived on
                self.down_epoch = self._epoch_fn()
            self.downs += 1
        _route.record_plane(self.name, "down")
        if self._events is not None:
            self._events("degraded", reason)
        return True

    # ---- the threaded revival (the bulk conn, the shm ring) -----------
    def kick(self) -> None:
        """Ensure exactly one revival loop runs (prober policy; a no-op
        when the gate says this end does not revive)."""
        if self._prober is None:
            return
        if self._gate is not None and not self._gate():
            return
        with self._lock:
            self.wanted = True
            if self.running:
                return           # the live loop will see `wanted`
            self.running = True
            if self.state != UP:
                self.state = REESTABLISHING
        threading.Thread(target=self._revival_loop,
                         name=self._thread_name, daemon=True).start()

    def _revival_loop(self) -> None:
        rng = random.Random(self._seed)
        delay = self._backoff_base
        while True:
            if self._dead is not None and self._dead():
                with self._lock:
                    self.running = False
                return
            with self._lock:
                if self._attached() or not self.wanted:
                    # exit atomically with clearing `running`: a racing
                    # kick saw running=True before this (and set wanted,
                    # keeping the loop) or starts a loop of its own
                    self.wanted = False
                    self.running = False
                    return
            # the backoff comes before each attempt, the first too: the
            # plane just died, and probing the instant the peer tears
            # down mostly burns a connection
            time.sleep(delay * (1.0 + 0.25 * rng.random()))
            delay = min(delay * 2, self._backoff_cap)
            with self._lock:
                if self._attached():
                    continue            # attached while we slept
            if self._dead is not None and self._dead():
                continue                # leave by the top of the loop
            _route.record_plane(self.name, "reprobe")
            if not self._prober():
                with self._lock:
                    self.probe_failures += 1

    def revived(self) -> bool:
        """The plane reports itself healthy again (its attach path, or
        before the latch lapsed).  Counts a revival only when the record
        was down (an initial attach is none), and arms the half-open
        ramp."""
        with self._lock:
            if self.state == UP:
                return False
            reason, self.reason = self.reason, ""
            self.state = UP
            self.down_until = 0.0
            self.probe_failures = 0
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "revived")
        self._revived_event(reason)
        return True

    def _revived_event(self, reason: str) -> None:
        if self._events is not None:
            self._events("revived", reason)

    # ---- the gate ------------------------------------------------------
    def usable(self, nbytes: int = 0) -> bool:
        """Gate one use of the plane (``route.candidates`` asks exactly
        this): UP runs the plane's capability probe (clearing a pending
        ramp); DOWN revives only as the plane's policy allows, and a
        prober plane stays unusable until its attach lands."""
        with self._lock:
            state = self.state
            ramp = state == UP and self.half_open
            if ramp:
                self.half_open = False
        if ramp:
            _route.record_plane(self.name, "ramp")
        if state != UP:
            if self._prober is not None:
                return False
            if self._retry_s is not None:
                if not self._lapse():
                    return False
            elif not self._epoch_revive():
                return False
        return self._probe(nbytes) if self._probe is not None else True

    def _lapse(self) -> bool:
        """Revive when the re-probe deadline lapsed: optimistic, the next
        failure re-latches."""
        with self._lock:
            if self.state == UP:
                return True
            if self.down_until and time.monotonic() < self.down_until:
                return False
            reason, self.reason = self.reason, ""
            self.state = UP
            self.down_until = 0.0
            self.probe_failures = 0
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "reprobe")
        _route.record_plane(self.name, "revived")
        self._revived_event(reason)
        return True

    def _epoch_revive(self) -> bool:
        """Epoch policy: revive when the epoch moved past the one
        recorded at the degrade (a member re-advertised), or, for a
        transient reason only, when the reprobe window elapsed.  A
        membership reason stays epoch-gated: a dead member does not come
        back by waiting."""
        with self._lock:
            if self.state == UP:
                return True
            down_epoch = self.down_epoch
            transient_expired = (
                self.reason in self._transient_reasons
                and self._reprobe_s is not None
                and time.monotonic() - self.down_at
                >= float(self._reprobe_s()))
        if not transient_expired and self._epoch_fn() <= down_epoch:
            return False
        with self._lock:
            if self.state == UP:
                return True
            reason, self.reason = self.reason, ""
            self.state = UP
            self.probe_failures = 0
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "reprobe")
        _route.record_plane(self.name, "revived")
        self._revived_event(reason)
        return True

    # ---- observability -------------------------------------------------
    def snapshot(self) -> dict:
        """State, reason, the epoch recorded at the degrade, transition
        tallies, failed revival attempts and, while a timer runs, seconds
        until the next re-probe."""
        now = time.monotonic()
        with self._lock:
            out = {"state": self.state, "reason": self.reason,
                   "down_epoch": self.down_epoch,
                   "downs": self.downs, "revivals": self.revivals,
                   "probe_failures": self.probe_failures,
                   "half_open": self.half_open}
            if self.down_until:
                out["reprobe_in"] = round(
                    max(0.0, self.down_until - now), 3)
            elif (self.state != UP and self._reprobe_s is not None
                    and self.reason in self._transient_reasons):
                out["reprobe_in"] = round(max(
                    0.0, self.down_at + float(self._reprobe_s()) - now), 3)
        return out


def register_plane(name: str, lock=None, **policy) -> PlaneHealth:
    """Register one plane: returns its :class:`PlaneHealth` record.
    ``lock`` is the plane's own guard (default: a fresh lock); ``policy``
    is the keyword surface of :class:`PlaneHealth`: ``prober`` (with
    ``attached``, ``dead``, ``gate``, ``seed`` and the backoff), ``retry_s``
    or ``epoch_fn`` (with ``transient_reasons`` and ``reprobe_s``) selects
    the revival policy, ``probe`` is the capability check and ``events``
    the plane's hook."""
    if lock is None:
        lock = threading.Lock()
    return PlaneHealth(name, lock, **policy)
