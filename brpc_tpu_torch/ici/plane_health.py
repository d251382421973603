"""One plane-health state machine for the planes that latch on a timer.

Port of :mod:`brpc_tpu.ici.plane_health`, the timer-latch policy with its
half-open ramp, which is what the KV pool's host tier (``spill``) and live
migration (``migrate``) register.  A plane registers a
:class:`PlaneHealth` record (:func:`register_plane`) and keeps its own
mechanics; the record owns:

  * the transitions ``UP -> DOWN(reason) -> UP`` and the one-transition-
    one-count discipline behind the ``<plane>_{down,reprobe,revived,
    ramp}`` counters (:mod:`.route`);
  * the timer latch: ``mark_down`` arms a re-probe deadline
    (``retry_s()`` seconds); the first :meth:`usable` after it lapses
    revives the plane optimistically, and the next failure re-latches.
    A ``mark_down`` while down re-arms the deadline without a second
    ``down`` count;
  * the ramp: a revival arms ``half_open``; the first :meth:`usable`
    under real traffic closes it and counts ``ramp``.

The threaded-prober policy (fabric bulk and shm planes) and the epoch
policy (collective fan-out) belong to planes that are not ported.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from . import route as _route

UP = "up"
DOWN = "down"


class PlaneHealth:
    """One plane's health record under the timer-latch policy.  All
    mutable state is guarded by the plane-supplied ``lock``; the counters
    tick outside it."""

    def __init__(self, name: str, lock, *,
                 retry_s: Callable[[], float]):
        self.name = name
        self._lock = lock
        self._retry_s = retry_s
        self.state = UP
        self.reason = ""
        self.down_until = 0.0        # 0 = up
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
            first = not self.down_until > now
            self.down_until = now + float(self._retry_s())
            self.reason = reason
            if not first:
                return False
            self.state = DOWN
            self.half_open = False
            self.downs += 1
        _route.record_plane(self.name, "down")
        return True

    def revived(self) -> bool:
        """The plane reports itself healthy again (before the latch
        lapsed).  Counts a revival only when the record was down, and arms
        the half-open ramp."""
        with self._lock:
            if self.state == UP:
                return False
            self.reason = ""
            self.state = UP
            self.down_until = 0.0
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "revived")
        return True

    # ---- the gate ------------------------------------------------------
    def usable(self) -> bool:
        """Gate one use of the plane: UP passes (clearing a pending ramp),
        DOWN revives only once the latch lapsed."""
        with self._lock:
            state = self.state
            ramp = state == UP and self.half_open
            if ramp:
                self.half_open = False
        if ramp:
            _route.record_plane(self.name, "ramp")
        return state == UP or self._lapse()

    def _lapse(self) -> bool:
        """Revive when the re-probe deadline lapsed: optimistic, the next
        failure re-latches."""
        with self._lock:
            if self.state == UP:
                return True
            if self.down_until and time.monotonic() < self.down_until:
                return False
            self.reason = ""
            self.state = UP
            self.down_until = 0.0
            self.half_open = True
            self.revivals += 1
        _route.record_plane(self.name, "reprobe")
        _route.record_plane(self.name, "revived")
        return True

    # ---- observability -------------------------------------------------
    def snapshot(self) -> dict:
        """State, reason, transition tallies and, while latched, seconds
        until the next re-probe.  ``down_epoch`` and ``probe_failures``
        keep the reference's row shape; without the epoch and prober
        policies they stay -1 and 0."""
        now = time.monotonic()
        with self._lock:
            out = {"state": self.state, "reason": self.reason,
                   "down_epoch": -1,
                   "downs": self.downs, "revivals": self.revivals,
                   "probe_failures": 0,
                   "half_open": self.half_open}
            if self.down_until:
                out["reprobe_in"] = round(
                    max(0.0, self.down_until - now), 3)
        return out


def register_plane(name: str, lock=None, **policy) -> PlaneHealth:
    """Register one plane: returns its :class:`PlaneHealth` record.
    ``lock`` is the plane's own guard (default: a fresh lock); ``policy``
    is ``retry_s`` (the timer latch, the only policy ported).  The
    reference's ``on_revive`` callback waits for a plane that uses it."""
    if lock is None:
        lock = threading.Lock()
    return PlaneHealth(name, lock, **policy)
