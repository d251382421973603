"""Lame-duck registry: which endpoints are draining, and who must know.

Port of :mod:`brpc_tpu.rpc.lameduck`.  Reference: ``Server::Stop(closewait_ms)``/``Join`` plus the
``-graceful_quit_on_sigterm`` doctrine (src/brpc/server.cpp,
docs/cn/server.md "优雅退出"): a *planned* shutdown is not a crash — the
server first flips to draining so every discovery surface pulls the
endpoint, then in-flight work completes inside a grace window, and only
stragglers are failed.

Two marks live here, both keyed by EndPoint:

  * **local** — a server in THIS process called ``stop(grace_s)`` and is
    draining.  The mark lives for the drain window only.
  * **peer** — a peer told us it is draining with the in-process ici
    ``GOODBYE`` (``IciSocket.send_goodbye``).  Registering a peer mark
    *proactively* pulls the endpoint from every live load balancer (no
    probe-timeout wait — the point of GOODBYE) and hands it to the
    health checker, whose successful probe after the peer's restart
    clears the mark and re-admits the endpoint everywhere.
"""
from __future__ import annotations

import signal
import threading
import time
import weakref
from typing import Dict, List

from ..butil import logging as log
from ..butil.endpoint import EndPoint

_lock = threading.Lock()
_local: Dict[EndPoint, float] = {}      # ep -> drain start (monotonic)
_peer: Dict[EndPoint, float] = {}       # ep -> GOODBYE receipt (monotonic)


# ---- local (this process's servers) -----------------------------------

def mark_local_draining(ep: EndPoint) -> None:
    with _lock:
        _local[ep] = time.monotonic()


def clear_local_draining(ep: EndPoint) -> None:
    with _lock:
        _local.pop(ep, None)


def local_draining() -> List[EndPoint]:
    with _lock:
        return list(_local)


# ---- peer (GOODBYE senders) -------------------------------------------

def notify_peer_draining(ep: EndPoint) -> bool:
    """A peer announced it is draining (GOODBYE).  Pull ``ep`` from every
    live load balancer NOW — before any health-check probe could have
    noticed — and register for revival.  Idempotent (GOODBYE may arrive
    on several sockets to the same server); returns True on the first
    registration."""
    with _lock:
        if ep in _peer:
            return False
        _peer[ep] = time.monotonic()
    log.info("lame duck: peer %s draining — pulled from load balancers", ep)
    _exclude_everywhere(ep, float("inf"))
    try:
        from .health_check import start_health_check
        start_health_check(ep, on_revived=_on_peer_revived)
    except Exception:
        pass
    return True


def peer_draining() -> List[EndPoint]:
    """The peers whose GOODBYE this process saw and whose revival has not
    come yet."""
    with _lock:
        return list(_peer)


def clear_peer_draining(ep: EndPoint) -> None:
    with _lock:
        _peer.pop(ep, None)
    _exclude_everywhere(ep, 0.0)


def _on_peer_revived(ep: EndPoint) -> None:
    log.info("lame duck: %s revived — re-admitted to load balancers", ep)
    clear_peer_draining(ep)


def _exclude_everywhere(ep: EndPoint, until_ts: float) -> None:
    from ..policy.load_balancers import live_load_balancers
    for lb in live_load_balancers():
        try:
            lb.exclude(ep, until_ts)
        except Exception:
            pass


def is_draining(ep: EndPoint) -> bool:
    with _lock:
        return ep in _local or ep in _peer


# ---- graceful_quit_on_sigterm -----------------------------------------
# One process-wide SIGTERM hook draining every registered server, so a
# deploy's TERM is invisible to callers: the handler flips servers to
# lame-duck (GOODBYE goes out, new requests bounce with retryable
# ELOGOFF) and drains them; a main thread blocked in
# Server.join() then unblocks and the process exits on its own.  The
# default disposition is restored afterwards, so a SECOND TERM kills
# immediately (the escalation contract).

_sig_servers: "weakref.WeakSet" = weakref.WeakSet()
_sig_installed = False


def enable_graceful_quit(server) -> bool:
    """Register ``server`` with the process SIGTERM drain hook, installing
    the hook on first use.  Returns False when the handler cannot be
    installed (not the main thread) — the server still drains via an
    explicit ``stop(grace_s)``."""
    global _sig_installed
    with _lock:
        _sig_servers.add(server)
        if _sig_installed:
            return True
        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            return False               # not the main thread
        _sig_installed = True
    return True


def _on_sigterm(signum, frame) -> None:
    # restore default FIRST: a second TERM during a long drain must kill
    # immediately instead of queueing another drain.  NO locks here — a
    # signal handler interrupts the main thread at an arbitrary point,
    # possibly while it holds this module's lock (self-deadlock).
    global _sig_installed
    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except ValueError:
        pass
    _sig_installed = False
    try:
        servers = list(_sig_servers)
    except RuntimeError:        # registration raced the iteration
        servers = []
    # drain off the signal frame: stop(grace) blocks for the grace window
    t = threading.Thread(target=_drain_servers, args=(servers,),
                         name="graceful_quit", daemon=True)
    t.start()


def _drain_servers(servers) -> None:
    # every server flips to draining IMMEDIATELY (GOODBYE out, ELOGOFF
    # bouncing) — a sequential stop would leave later
    # servers advertising healthy through every earlier server's grace
    # window, and an orchestrator kill-timeout would SIGKILL them
    # mid-traffic; total shutdown is max-of-graces, not sum
    def one(s):
        try:
            grace = getattr(s.options, "graceful_shutdown_s", 0.0) or 0.0
            s.stop(grace)
        except Exception:
            log.error("graceful_quit: drain failed", exc_info=True)

    threads = [threading.Thread(target=one, args=(s,),
                                name="graceful_quit_drain", daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
