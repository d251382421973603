"""Live cross-worker KV migration: move a live session's blocks to another
decode worker's pool instead of re-prefilling it.

Port of :mod:`brpc_tpu.serving.migration`.  The source copy stays
authoritative until the destination has committed:

  * :func:`migrate_out` pins the source session (restoring it from the
    host tier first if it was spilled: a migration is a read) and takes
    the payload up front with the pool's ``snapshot`` gather, a private
    ``(seq_len, bytes_per_token)`` tensor on the pool's device.  A sender
    abandoned past the deadline therefore holds its own bytes and can
    never ship arena rows freed and reused after the abort.
  * ``send(meta, payload) -> (ok, err, shed)`` is the caller's wire.  The
    disaggregated example's ``Decode.MigrateOut`` appends the payload as
    a DEVICE attachment to ``Decode.MigrateIn``; over ``ici://`` the
    transport relocates it to the destination rank on the device plane,
    one ``p2p_copy`` launch per migration.  ``shed=True`` marks a clean
    refusal (destination saturated or the session busy there), which
    aborts without a plane event.
  * the "migrate" plane-health row is the transfer-deadline latch: a send
    that neither completes nor fails within the deadline marks the plane
    down (``transfer_deadline``); a send that fails without a shed marks
    it down (``peer_unreachable``).  Every later ``migrate_out`` refuses
    fast until the timer latch lapses and the plane revives.
  * only after the destination commits does the source release: the
    caller's ``on_cutover`` runs first (the routing flip: an in-process
    ``LoadAwareRouter.rebind``, or the disaggregated example's record of
    the destination, which sheds a late Decode towards it), then the pin
    drops and the blocks free.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

from .. import bvar
from ..butil import flags as _flags

_flags.define_flag(
    "serving_migrate_deadline_ms", 2000,
    "transfer-deadline latch for live KV migration: a send that neither "
    "completes nor fails within this window marks the migrate plane down "
    "and the migration aborts with the source copy intact")

_flags.define_flag(
    "serving_migrate_reprobe_s", 0.5,
    "migrate plane-health timer latch: how long after a transfer deadline "
    "or peer failure before the next migrate_out re-probes the plane")


class _MigrationStats:
    """Process-wide migration ledger: ``describe()["tiers"]["migration"]``
    and the tests' assertion surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_abort = ""
        self.migrations_out = bvar.Adder("serving_kv_migrations_out")
        self.migrations_in = bvar.Adder("serving_kv_migrations_in")
        self.cutovers = bvar.Adder("serving_kv_migration_cutovers")
        self.aborts = bvar.Adder("serving_kv_migration_aborts")
        self.bytes_moved = bvar.Adder("serving_kv_migration_bytes")

    def abort(self, reason: str) -> None:
        self.aborts << 1
        with self._lock:
            self._last_abort = reason

    def snapshot(self) -> dict:
        with self._lock:
            last = self._last_abort
        return {
            "migrations_out": self.migrations_out.get_value(),
            "migrations_in": self.migrations_in.get_value(),
            "cutovers": self.cutovers.get_value(),
            "aborts": self.aborts.get_value(),
            "bytes_moved": self.bytes_moved.get_value(),
            "last_abort": last,
        }


stats = _MigrationStats()

_health = None
_health_lock = threading.Lock()


def migrate_health():
    """The process-wide "migrate" plane-health row (timer latch), created
    on first use so a process that never migrates never registers it."""
    global _health
    with _health_lock:
        if _health is None:
            from ..ici.plane_health import register_plane
            _health = register_plane(
                "migrate", retry_s=lambda: float(_flags.get_flag(
                    "serving_migrate_reprobe_s")))
        return _health


def migration_stats() -> dict:
    """The ledger plus the plane row, once the plane exists."""
    out = stats.snapshot()
    with _health_lock:
        h = _health
    if h is not None:
        out["plane"] = h.snapshot()
    return out


def migrate_out(pool, session: str,
                send: Callable[[dict, object], Tuple[bool, str, bool]], *,
                scheduler=None,
                on_cutover: Optional[Callable[[], None]] = None,
                deadline_ms: Optional[int] = None) -> Tuple[bool, str]:
    """Move one session's KV to another worker's pool.  Returns ``(ok,
    reason)``; every failure leaves the SOURCE copy authoritative.

    ``send(meta, payload)`` ships the token-major payload tensor and
    returns ``(ok, err, shed)``; it runs on its own thread under the
    transfer-deadline latch.  ``scheduler`` fences sessions the decode
    roster owns.  ``on_cutover`` is the routing flip, called after the
    destination committed and before the source releases."""
    health = migrate_health()
    if not health.usable():
        stats.abort("plane down")
        return False, "migrate plane down (latched): retry later"
    if scheduler is not None and scheduler.owns(session):
        stats.abort("session decoding")
        return False, f"session {session!r} is decoding: drain first"
    if not pool.pin(session):
        stats.abort("unknown session")
        return False, f"unknown session {session!r}"
    try:
        snap = pool.snapshot(session)
        s = pool.get(session)
        if snap is None or s is None:
            stats.abort("session vanished")
            return False, f"session {session!r} vanished under the pin"
        # the up-front copy: the gather is a tensor of its own
        payload, seq_len, last_token = snap
        meta = {"session": session, "seq_len": int(seq_len),
                "last_token": int(last_token), "tenant": s.tenant,
                "priority": int(s.priority)}
        result = {}
        done = threading.Event()

        def _runner():
            try:
                result["r"] = send(meta, payload)
            except Exception as e:   # a raising send is a dead peer
                result["r"] = (False, f"{type(e).__name__}: {e}", False)
            finally:
                done.set()

        dl_ms = deadline_ms if deadline_ms is not None else int(
            _flags.get_flag("serving_migrate_deadline_ms"))
        threading.Thread(target=_runner, name="kv_migrate_send",
                         daemon=True).start()
        if not done.wait(dl_ms / 1000.0):
            # a hung peer is detected here, by the transfer deadline
            health.mark_down("transfer_deadline")
            stats.abort("transfer deadline")
            return False, (f"transfer exceeded {dl_ms}ms deadline: "
                           "migrate plane latched down")
        ok, err, shed = result["r"]
        if not ok:
            if not shed:
                # the peer, not the payload, is the problem
                health.mark_down("peer_unreachable")
            stats.abort(err or "send failed")
            return False, err or "send failed"
        stats.migrations_out << 1
        stats.bytes_moved << payload.numel()
        if on_cutover is not None:
            on_cutover()
        stats.cutovers << 1
    finally:
        pool.unpin(session)
    pool.release(session)
    return True, ""
