"""custody_ledger: opt-in runtime acquire/release accounting for the
resources fablint's ``custody`` family checks lexically.

The static pass (``brpc_tpu_torch/tools/fablint.py``, ``custody`` +
``refcount-balance``)
proves the LEXICAL shape: every declared acquisition releases on every
exit path or carries an explicit transfer marker.  What it cannot see
is a transfer marker whose far end never fires — a roster pin whose
completion path dies, a pooled controller recycled into the void, a
parked device ref dropped by a killed peer.  This module is the runtime
complement: every declared acquire/release point records a
stack-tagged ledger entry, so a leak report names the ACQUIRING
file:line and the unbalanced resource — not just "a pin leaked
somewhere" (``tests/torch_census.py`` reads it after every test of the
port's hooked paths).

Resources are short stable strings (``"kv.pin"``, ``"kv.reserve"``,
``"cntl"``, ``"stream"``, ``"dma.src"``, ``"devref"``); keys are
hashable tuples identifying ONE custody instance (pool id + session,
registry key, stream sid).  Acquires on the same key NEST (counted
pins); each release drops one hold, and the entry disappears at zero.

Production cost is ZERO: every hook early-outs on the ``debug_custody``
flag (enable at import time via ``BRPC_TPU_DEBUG_CUSTODY=1``, exactly
like ``debug_lock_order``).  When ``BRPC_TPU_CUSTODY_REPORT=<path>`` is
set an atexit hook dumps the JSON report there — the chaos suite's
child processes hand their ledgers back to the asserting test that way
(``os._exit`` children call :func:`dump_report_now` first).
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
from typing import Dict, List, Tuple

from . import flags as _flags

_flag = _flags.define_flag("debug_custody", False,
                   "instrument declared custody points (pins, refcounts, "
                   "reservations, pooled handles): runtime acquire/"
                   "release ledger with stack-tagged leak attribution "
                   "(opt-in; every hook is a no-op when off)")

_state_lock = threading.Lock()
# (resource, key) -> list of hold records, one per outstanding acquire
_holds: Dict[Tuple[str, tuple], List[dict]] = {}
_unmatched: List[dict] = []

# fablint guarded-state contract for this module's own registries
_GUARDED_BY_GLOBALS = {
    "_holds": "_state_lock",
    "_unmatched": "_state_lock",
}


# The flag's value, read by a C-level callable: a hook costs the
# instrumented path one interpreter frame (its own), which keeps the
# native door's fused echo inside its frame budget with the ledger on
# (``tests/test_torch_native_ici.py``'s test_frame_budget runs under
# ``BRPC_TPU_DEBUG_CUSTODY=1``).  A test may replace ``enabled``.
enabled = functools.partial(getattr, _flag, "value")


def _caller_site(depth: int = 4) -> str:
    # walk depth-1 frames out past _caller_site -> acquire/release ->
    # the instrumented method to its CALL SITE, the frame a human needs
    # to find the leak.  sys._getframe is a C call — unlike
    # traceback.extract_stack it creates no interpreter frames
    try:
        fr = sys._getframe(depth - 1)
    except ValueError:
        return "?"
    return f"{os.path.basename(fr.f_code.co_filename)}:{fr.f_lineno}"


def _thread_names(records: List[dict]) -> List[dict]:
    """Records with the acquiring thread's name in place of its ident
    (a thread that has ended keeps ``thread-<ident>``)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for r in records:
        r = dict(r)
        ident = r["thread"]
        if isinstance(ident, int):
            r["thread"] = names.get(ident, f"thread-{ident}")
        out.append(r)
    return out


def acquire(resource: str, key: tuple, depth: int = 4) -> None:
    """Record one acquisition of ``(resource, key)``.  ``depth`` picks
    the attributed stack frame: the default names the caller of the
    instrumented method (``pool.pin(...)``'s call site), which is the
    frame a human needs to find the leak."""
    if not enabled():
        return
    # the site and the thread's ident are read in C (sys._getframe,
    # str.rpartition, get_ident): the hook adds no interpreter frame
    # beyond its own
    try:
        fr = sys._getframe(depth - 2)
        site = f"{fr.f_code.co_filename.rpartition(os.sep)[2]}:{fr.f_lineno}"
    except ValueError:
        site = "?"
    rec = {"resource": resource, "key": list(key), "site": site,
           "thread": threading.get_ident()}
    with _state_lock:
        _holds.setdefault((resource, tuple(key)), []).append(rec)


def release(resource: str, key: tuple, strict: bool = False) -> None:
    """Drop one hold of ``(resource, key)``.  Non-strict (the default)
    ignores unknown keys — generic return paths (``
    _return_blocks_locked``) run for lists that were never ledgered.
    ``strict=True`` records an unmatched release instead (an unpin
    nobody holds is itself a custody bug)."""
    if not enabled():
        return
    k = (resource, tuple(key))
    with _state_lock:
        held = _holds.get(k)
        if held:
            held.pop()
            if not held:
                del _holds[k]
        elif strict:
            _unmatched.append({"resource": resource, "key": list(key),
                               "site": _caller_site(),
                               "thread": threading.get_ident()})


def drop_prefix(resource: str, key_head) -> int:
    """Forget every hold of ``resource`` whose key starts with
    ``key_head`` — a pool ``close()`` ends custody of everything it
    owned (the free-list rebuild reclaimed the blocks; outstanding
    pins die with the tables).  Returns the number of holds dropped."""
    if not enabled():
        return 0
    n = 0
    with _state_lock:
        for k in [k for k in _holds
                  if k[0] == resource and k[1][:1] == (key_head,)]:
            n += len(_holds.pop(k))
    return n


def outstanding() -> List[dict]:
    """Every unreleased acquisition, stack-tagged."""
    with _state_lock:
        recs = [r for held in _holds.values() for r in held]
    return _thread_names(recs)


def report() -> dict:
    out = outstanding()
    with _state_lock:
        um = list(_unmatched)
    um = _thread_names(um)
    return {"enabled": bool(enabled()), "outstanding": out,
            "unmatched_releases": um,
            "ok": not out and not um}


def reset() -> None:
    with _state_lock:
        _holds.clear()
        del _unmatched[:]


def dump_report_now() -> None:
    """Write the report to $BRPC_TPU_CUSTODY_REPORT immediately — for
    processes that exit via os._exit (skipping atexit) but still want
    their ledger asserted by the parent test."""
    path = os.environ.get("BRPC_TPU_CUSTODY_REPORT")
    if not path:
        return
    try:
        with open(path, "w") as f:
            json.dump(report(), f)
    except OSError:
        pass


if os.environ.get("BRPC_TPU_CUSTODY_REPORT"):
    atexit.register(dump_report_now)
