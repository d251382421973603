"""One plane-health state machine for the planes that latch on a timer
or on an epoch.

Port of :mod:`brpc_tpu.ici.plane_health`.  A plane registers a
:class:`PlaneHealth` record (:func:`register_plane`) and keeps its own
mechanics; the record owns:

  * the transitions ``UP -> DOWN(reason) -> UP`` and the one-transition-
    one-count discipline behind the ``<plane>_{down,reprobe,revived,
    ramp}`` counters (:mod:`.route`);
  * the revival policy, one of two, chosen by what the plane registers:

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

The threaded-prober policy (the fabric's bulk and shm planes) waits for
those planes.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

from . import route as _route

UP = "up"
DOWN = "down"


class PlaneHealth:
    """One plane's health record.  All mutable state is guarded by the
    plane-supplied ``lock``; counters and hooks run outside it."""

    def __init__(self, name: str, lock, *,
                 retry_s: Optional[Callable[[], float]] = None,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 transient_reasons: Tuple[str, ...] = (),
                 reprobe_s: Optional[Callable[[], float]] = None,
                 events: Optional[Callable[[str, str], None]] = None):
        if (retry_s is None) == (epoch_fn is None):
            raise TypeError("a plane registers exactly one revival "
                            "policy: retry_s or epoch_fn")
        self.name = name
        self._lock = lock
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

    def revived(self) -> bool:
        """The plane reports itself healthy again (before the latch
        lapsed).  Counts a revival only when the record was down, and arms
        the half-open ramp."""
        with self._lock:
            if self.state == UP:
                return False
            reason, self.reason = self.reason, ""
            self.state = UP
            self.down_until = 0.0
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "revived")
        self._revived_event(reason)
        return True

    def _revived_event(self, reason: str) -> None:
        if self._events is not None:
            self._events("revived", reason)

    # ---- the gate ------------------------------------------------------
    def usable(self) -> bool:
        """Gate one use of the plane: UP passes (clearing a pending ramp);
        DOWN revives only as the plane's policy allows."""
        with self._lock:
            state = self.state
            ramp = state == UP and self.half_open
            if ramp:
                self.half_open = False
        if ramp:
            _route.record_plane(self.name, "ramp")
        if state == UP:
            return True
        if self._retry_s is not None:
            return self._lapse()
        return self._epoch_revive()

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
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "reprobe")
        _route.record_plane(self.name, "revived")
        self._revived_event(reason)
        return True

    # ---- observability -------------------------------------------------
    def snapshot(self) -> dict:
        """State, reason, the epoch recorded at the degrade, transition
        tallies and, while a timer runs, seconds until the next re-probe.
        ``probe_failures`` keeps the reference's row shape; without the
        prober policy it stays 0."""
        now = time.monotonic()
        with self._lock:
            out = {"state": self.state, "reason": self.reason,
                   "down_epoch": self.down_epoch,
                   "downs": self.downs, "revivals": self.revivals,
                   "probe_failures": 0,
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
    is the keyword surface of :class:`PlaneHealth`: ``retry_s`` or
    ``epoch_fn`` (with ``transient_reasons`` and ``reprobe_s``) selects
    the revival policy, and ``events`` is the plane's hook."""
    if lock is None:
        lock = threading.Lock()
    return PlaneHealth(name, lock, **policy)
