"""debug_sync: opt-in runtime lock-order and long-hold instrumentation.

The runtime half of fablint (``brpc_tpu_torch/tools/fablint.py``): the
static analyzer sees
only LEXICAL nesting, so a lock order established across call frames —
``A.acquire()`` in one function calling into another that takes ``B`` —
is invisible to it.  This module is the TSan-shaped complement: an
instrumented Lock/RLock factory that records per-thread acquisition
stacks, maintains the process-global runtime lock-ORDER graph, and
reports

  * **cycles** — thread 1 acquires A→B while thread 2 ever acquired
    B→A: the classic deadlock shape, reported the moment the second
    edge closes the cycle (no actual deadlock required — exactly like
    TSan's lock-order-inversion report), and
  * **long holds** — a lock held longer than ``debug_lock_hold_warn_s``
    (blocking call under a lock, the fablint blocking-under-lock class,
    but caught at runtime wherever it hides from the lexical pass).

Production cost is ZERO: ``make_lock()`` returns a plain
``threading.Lock`` unless the ``debug_lock_order`` flag is on **at
creation time** (module-level locks are created at import, so enable
via the ``BRPC_TPU_DEBUG_LOCK_ORDER=1`` environment override to catch
them; per-object locks honor a flag flipped at runtime).

Reports: :func:`report` returns the graph + violations; when
``BRPC_TPU_DEBUG_SYNC_REPORT=<path>`` is set and the flag is on, an
atexit hook dumps the JSON report there — that is how the chaos suite's
child processes hand their runtime graphs back to the asserting test
(``tests/test_torch_chaos_fabric.py`` and ``tests/test_torch_pod.py``
run their children under this layer, and ``chip_smoke.py`` phase 27
drives the main path on the card under it).

Identity: locks are named (``make_lock("FabricSocket._bulk_lock")``);
unnamed locks get ``module:line`` of their creation site.  The graph is
keyed by NAME, not instance — every FabricSocket's ``_bulk_lock`` is
one node, which is what makes cross-object cycles (socket A's reader
locking socket B) visible instead of drowned in per-instance noise.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from . import flags as _flags

_flags.define_flag("debug_lock_order", False,
                   "instrument make_lock() locks: runtime lock-order "
                   "graph, cycle + long-hold reporting (opt-in; plain "
                   "threading.Lock when off)")
_flags.define_flag("debug_lock_hold_warn_s", 1.0,
                   "debug_lock_order: holding one lock longer than this "
                   "records a long-hold violation")

_state_lock = threading.Lock()
# edge graph: name -> set of names acquired while holding it
_edges: Dict[str, Set[str]] = {}
# first-seen location per edge (for reports)
_edge_sites: Dict[Tuple[str, str], str] = {}
_cycles: List[dict] = []
_long_holds: List[dict] = []
_seen_cycle_keys: Set[tuple] = set()
# every lock name acquired at least once (the graph's nodes, nested or
# not); each thread keeps the names it published under _nodes_gen, which
# reset() moves on
_nodes: Set[str] = set()
_nodes_gen = [0]
_tls = threading.local()

# fablint guarded-state contract for this module's own registries
_GUARDED_BY_GLOBALS = {
    "_edges": "_state_lock",
    "_edge_sites": "_state_lock",
    "_cycles": "_state_lock",
    "_long_holds": "_state_lock",
    "_seen_cycle_keys": "_state_lock",
    "_nodes": "_state_lock",
}


def _held_stack() -> list:
    s = getattr(_tls, "held", None)
    if s is None:
        s = _tls.held = []
    return s


def _caller_site(depth: int = 3) -> str:
    """``file:line`` of the frame ``depth`` levels above this one (the
    outermost frame when the stack is shallower).  ``sys._getframe``
    reads no source file, unlike ``traceback.extract_stack``, so taking
    a site on every acquire costs the instrumented path little."""
    fr = sys._getframe(1)
    for _ in range(depth - 1):
        if fr.f_back is None:
            break
        fr = fr.f_back
    return f"{os.path.basename(fr.f_code.co_filename)}:{fr.f_lineno}"


def _path_exists(src: str, dst: str) -> bool:
    """True when dst is reachable from src in the edge graph.
    Callers hold _state_lock."""
    seen = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))   # fablint: ignore[guarded-state] helper runs under _state_lock (single caller _on_acquired holds it)
    return False


def _on_acquired(name: str, site: str, lock_id: int) -> None:
    held = _held_stack()
    gen, seen = getattr(_tls, "seen", (-1, None))
    if gen != _nodes_gen[0]:
        seen = set()
        _tls.seen = (_nodes_gen[0], seen)
    if name not in seen:
        # a name this thread has not taken yet: publish the node (the
        # thread-local set keeps the common case off _state_lock)
        seen.add(name)
        with _state_lock:
            _nodes.add(name)
    if held:
        outer, _, _, outer_id = held[-1]
        # same-name nesting across DIFFERENT instances records a
        # self-edge: two objects of one class locked nested have no
        # defined order, the classic same-class ABBA shape
        if outer != name or outer_id != lock_id:
            with _state_lock:
                new_edge = name not in _edges.get(outer, ())
                if new_edge:
                    _edges.setdefault(outer, set()).add(name)
                    _edge_sites[(outer, name)] = site
                    # closing edge of a cycle?  (reverse reachability)
                    if _path_exists(name, outer):
                        key = (name, outer)
                        if key not in _seen_cycle_keys:
                            _seen_cycle_keys.add(key)
                            _cycles.append({
                                "edge": f"{outer} -> {name}",
                                "site": site,
                                "conflicts_with":
                                    f"existing path {name} ~> {outer}",
                                "thread": threading.current_thread().name,
                            })
    held.append((name, time.monotonic(), site, lock_id))


def _on_released(name: str, lock_id: int) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name and held[i][3] == lock_id:
            _, t0, site, _ = held.pop(i)
            dur = time.monotonic() - t0
            warn = _flags.get_flag("debug_lock_hold_warn_s")
            if dur > warn:
                with _state_lock:
                    _long_holds.append({
                        "lock": name, "held_s": round(dur, 3),
                        "site": site,
                        "thread": threading.current_thread().name,
                    })
            return


class DebugLock:
    """threading.Lock drop-in recording order edges and hold times.
    RLock variant: re-entrant re-acquisition is NOT a new edge, and
    the lock stays on the held stack (recording edges + hold time)
    until the OUTERMOST release — per-thread depth counting; popping
    on the inner release would hide every edge taken while still held."""

    __slots__ = ("_lock", "name", "_reentrant")

    def __init__(self, name: str, reentrant: bool = False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.name = name
        self._reentrant = reentrant

    def _depths(self) -> dict:
        d = getattr(_tls, "rdepth", None)
        if d is None:
            d = _tls.rdepth = {}
        return d

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._reentrant:
            d = self._depths()
            if d.get(id(self), 0) > 0:
                ok = self._lock.acquire(blocking, timeout)   # re-entry
                if ok:
                    d[id(self)] += 1
                return ok
        site = _caller_site()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _on_acquired(self.name, site, id(self))
            if self._reentrant:
                self._depths()[id(self)] = 1
        return ok

    def release(self) -> None:
        if self._reentrant:
            d = self._depths()
            depth = d.get(id(self), 0)
            if depth > 1:
                d[id(self)] = depth - 1
                self._lock.release()
                return
            d.pop(id(self), None)
        _on_released(self.name, id(self))
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self.name}>"


def make_lock(name: Optional[str] = None):
    """The factory the hot modules create their locks through: a plain
    ``threading.Lock`` in production, a :class:`DebugLock` when
    ``debug_lock_order`` is on at creation time."""
    if not _flags.get_flag("debug_lock_order"):
        return threading.Lock()
    return DebugLock(name or _caller_site(2))


def make_rlock(name: Optional[str] = None):
    if not _flags.get_flag("debug_lock_order"):
        return threading.RLock()
    return DebugLock(name or _caller_site(2), reentrant=True)


def report() -> dict:
    """Snapshot: the runtime acquisition graph, detected cycles, and
    long holds.  ``nodes`` names every lock acquired at least once,
    nested or not.  ``ok`` is True iff zero cycles and zero long
    holds."""
    with _state_lock:
        return {
            "edges": {a: sorted(bs) for a, bs in sorted(_edges.items())},
            "edge_sites": {f"{a} -> {b}": s
                           for (a, b), s in sorted(_edge_sites.items())},
            "cycles": list(_cycles),
            "long_holds": list(_long_holds),
            "nodes": sorted(_nodes),
            "ok": not _cycles and not _long_holds,
        }


def reset() -> None:
    """Clear all recorded state (test isolation)."""
    with _state_lock:
        _edges.clear()
        _edge_sites.clear()
        _cycles.clear()
        _long_holds.clear()
        _seen_cycle_keys.clear()
        _nodes.clear()
        _nodes_gen[0] += 1


def dump_report_now() -> None:
    """Write the report to $BRPC_TPU_DEBUG_SYNC_REPORT immediately —
    for processes that exit via os._exit (skipping atexit) but still
    owe the parent their graph (the chaos peer-kill survivor)."""
    path = os.environ.get("BRPC_TPU_DEBUG_SYNC_REPORT")
    if not path or not _flags.get_flag("debug_lock_order"):
        return
    try:
        with open(path, "w") as f:
            json.dump(report(), f, indent=2)
    except Exception:
        pass


if os.environ.get("BRPC_TPU_DEBUG_SYNC_REPORT"):
    atexit.register(dump_report_now)
