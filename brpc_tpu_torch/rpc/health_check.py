"""Health checking: revive failed endpoints.

Port of :mod:`brpc_tpu.rpc.health_check` (reference:
src/brpc/details/health_check.{h,cpp} :42-237): failed or draining
endpoints are probed periodically (is a server listening there); on
success the endpoint returns to service and its circuit breaker is
reset.  Probing runs on the shared TimerThread.
The port probes ``mem://`` and ``ici://`` endpoints in process, an
``ici://`` rank another process owns with the fabric's connectionless
PING, and a TCP endpoint with a connect.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, Optional

from ..butil import debug_sync as _dbg
from ..butil.endpoint import EndPoint, SCHEME_ICI, SCHEME_MEM, SCHEME_TCP
from ..butil import flags as _flags
from ..butil import logging as log
from ..bthread.timer_thread import TimerThread
from .circuit_breaker import BreakerRegistry

_flags.define_flag("health_check_interval_s", 0.1,
                   "first probe delay for a failed endpoint (doubles per "
                   "failed probe up to health_check_max_interval_s)")
_flags.define_flag("health_check_max_interval_s", 2.0,
                   "cap on the exponential probe backoff")
_flags.define_flag("health_check_jitter", 0.2,
                   "fraction of the probe interval added as seeded "
                   "random jitter (de-synchronizes probers)")


def probe_endpoint(ep: EndPoint, timeout: float = 1.0) -> bool:
    """Reachability probe (the reference's periodic connect): a server
    listens on ``ep`` in this process and is not draining.  A draining
    server keeps its listener open for the grace window, so new callers
    get its retryable ELOGOFF bounce; it is not alive for the checker.
    ``timeout`` bounds a TCP connect and a fabric PING."""
    if ep.scheme == SCHEME_MEM:
        from .mem_transport import _listeners, _listeners_lock
        with _listeners_lock:
            listener = _listeners.get(ep.host)
    elif ep.scheme == SCHEME_ICI:
        from ..ici.transport import _listeners, _listeners_lock
        with _listeners_lock:
            listener = _listeners.get(ep.device_id)
        if listener is None:
            # a rank another process owns: ask its fabric control
            # listener (no fabric socket is made for the probe)
            from ..ici.fabric import FabricNode
            node = FabricNode.instance()
            if node is not None and not node.owns(ep.device_id):
                return node.ping(ep.device_id, timeout=timeout)
    elif ep.scheme == SCHEME_TCP:
        import socket
        try:
            with socket.create_connection((ep.host, ep.port),
                                          timeout=timeout):
                return True
        except OSError:
            return False
    else:
        return False
    return listener is not None and not listener.draining


class HealthCheckTask:
    """Repeating probe for one endpoint until it revives.  Probe delays
    back off exponentially (base health_check_interval_s, doubling to
    health_check_max_interval_s) with jitter seeded from the endpoint, so
    a fleet of checkers never stampedes a recovering peer.  ``app_check``
    (an application-level probe, called once the transport probe passes)
    must also pass for a revival; ``max_probes`` (0: unlimited) gives up
    after that many failed probes; ``seed`` seeds the jitter in place of
    the endpoint's hash."""

    _GUARDED_BY = {"_revive_cbs": "_tasks_lock"}

    def __init__(self, ep: EndPoint,
                 on_revived: Optional[Callable[[EndPoint], None]] = None,
                 app_check: Optional[Callable[[EndPoint], bool]] = None,
                 max_probes: int = 0, seed: Optional[int] = None):
        self.ep = ep
        self.on_revived = on_revived
        self.app_check = app_check
        self.max_probes = max_probes
        # more revival callbacks, keyed by the registering call site's
        # code object: several parties can care about one endpoint's
        # revival, and a repeated registration replaces its own entry
        self._revive_cbs: Dict[Any, Callable[[EndPoint], None]] = {}
        self.probe_count = 0
        self._rng = random.Random(
            seed if seed is not None else hash(ep) & 0xFFFFFFFF)
        self._cancelled = threading.Event()
        self._schedule()

    def next_delay_s(self) -> float:
        base = _flags.get_flag("health_check_interval_s")
        cap = _flags.get_flag("health_check_max_interval_s")
        d = min(base * (2 ** min(self.probe_count, 16)), cap)
        return d * (1.0 + _flags.get_flag("health_check_jitter")
                    * self._rng.random())

    def _schedule(self) -> None:
        TimerThread.instance().schedule_after(self._probe,
                                              self.next_delay_s())

    def _probe(self) -> None:
        """The timer's probe: on failure the next one is scheduled, up
        to ``max_probes``."""
        if self._cancelled.is_set() or self.probe_now():
            return
        if self.max_probes and self.probe_count >= self.max_probes:
            _unregister(self.ep)
            return
        self._schedule()

    def probe_now(self) -> bool:
        """One probe on the calling thread; True when it revived the
        endpoint (the breaker reset and the callbacks ran)."""
        if self._cancelled.is_set():
            return False
        self.probe_count += 1
        ok = probe_endpoint(self.ep)
        if ok and self.app_check is not None:
            try:
                ok = bool(self.app_check(self.ep))
            except Exception:
                ok = False
        if not ok:
            return False
        # revived once: a probe still on the timer finds the task done
        self._cancelled.set()
        BreakerRegistry.instance().breaker(self.ep).mark_recovered()
        _unregister(self.ep)
        # snapshot under the registry lock: start_health_check inserts
        # callbacks concurrently (channel breaker trips on other threads)
        with _tasks_lock:
            cbs = list(self._revive_cbs.values())
        if self.on_revived is not None:
            cbs.insert(0, self.on_revived)
        for cb in cbs:
            try:
                cb(self.ep)
            except Exception:
                log.error("revival callback for %s raised", self.ep,
                          exc_info=True)
        log.info("endpoint %s revived after %d probes", self.ep,
                 self.probe_count)
        return True

    def cancel(self) -> None:
        self._cancelled.set()
        _unregister(self.ep)


_tasks: Dict[EndPoint, HealthCheckTask] = {}
_tasks_lock = _dbg.make_lock("health_check._tasks_lock")

_GUARDED_BY_GLOBALS = {"_tasks": "_tasks_lock"}


def start_health_check(ep: EndPoint,
                       on_revived: Optional[Callable] = None,
                       app_check: Optional[Callable] = None,
                       revive_key: Any = None) -> HealthCheckTask:
    """Ensure ``ep`` is under probing.  ``on_revived`` registers a
    revival callback, keyed by ``revive_key`` (default: its code object),
    so repeated registrations from one call site replace rather than
    accumulate.  ``app_check`` is the new task's application-level
    probe."""
    with _tasks_lock:
        t = _tasks.get(ep)
        if t is None:
            t = HealthCheckTask(ep, on_revived, app_check)
            _tasks[ep] = t
        elif on_revived is not None and t.on_revived is not on_revived:
            key = revive_key if revive_key is not None \
                else getattr(on_revived, "__code__", on_revived)
            t._revive_cbs[key] = on_revived
        return t


def _unregister(ep: EndPoint) -> None:
    with _tasks_lock:
        _tasks.pop(ep, None)


def checking(ep: EndPoint) -> bool:
    with _tasks_lock:
        return ep in _tasks
