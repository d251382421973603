"""The usercode pool: the backup thread pool behind
``ServerOptions.usercode_in_pthread``, and handlers that scale past the GIL.

Port of :mod:`brpc_tpu.rpc.usercode_pool`.  The reference runs usercode
on an M:N bthread scheduler precisely so one slow handler never
serializes the process.  ``usercode_in_pthread`` routes handlers to a
backup THREAD pool, which protects the dispatch loop, but every handler
still funnels through the one GIL.  This module puts an ISOLATION backend
behind the same seam:

* **probe once** (:func:`probe_isolation`): free-threading CPython (GIL
  disabled) scales with plain threads; CPython >= 3.12 gives
  subinterpreters their own GIL; 3.8-3.11 subinterpreters work but SHARE
  the GIL (isolation without scaling, and the capability record says
  so); anything else falls back to the plain backup pool.
* **UsercodePool**: the backup ``ThreadPoolExecutor`` surface
  (``submit``/``shutdown``) carries regular handlers, the queued-counter
  accounting, the drain bounce and the admission ordering.  On top,
  *registered* isolated handlers (:meth:`UsercodePool.register` +
  :meth:`UsercodePool.call_isolated`) run inside per-worker
  subinterpreters under an explicit SHARE-NOTHING contract: handler
  source crosses as a string at registration, per-call arguments cross
  only as bytes; anything else is refused with a clear TypeError.  A
  subinterpreter cannot load ``torch``, so an isolated handler's source
  imports none of it.
* **worker-death resilience**: a worker that dies mid-task (chaos hook
  :attr:`UsercodePool.chaos_kill_next`) requeues its in-hand task onto a
  replacement worker — zero caller-visible failures, counted in
  ``describe()``.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from collections import namedtuple
from typing import Dict, Optional

from ..butil import debug_sync as _dbg
from ..butil import logging as log

IsolationCaps = namedtuple(
    "IsolationCaps", ("mode", "functional", "scaling", "reason"))

_caps: Optional[IsolationCaps] = None
_caps_lock = threading.Lock()

# the process-wide backend of servers configured "auto": rpc_press's
# --usercode-pool pins it for the servers it hosts
_default_kind = "auto"


def set_default_kind(kind: str) -> None:
    """The backend that "auto"-configured pools resolve to ("auto"
    restores the resolution by capability)."""
    global _default_kind
    if kind not in ("auto", "pthread", "subinterp"):
        raise ValueError(f"unknown usercode pool kind {kind!r}")
    _default_kind = kind


def default_kind() -> str:
    return _default_kind


def probe_isolation() -> IsolationCaps:
    """Probe the interpreter's isolation capability ONCE per process.

    ``mode``: "free-threading" | "subinterp" | "subinterp-shared-gil" |
    "none".  ``functional`` — isolated registration/dispatch works;
    ``scaling`` — isolated handlers can actually run CPU concurrently
    (given more than one core).  ``reason`` says why a capability is
    missing."""
    global _caps
    if _caps is not None:
        return _caps
    with _caps_lock:
        if _caps is not None:
            return _caps
        gil_check = getattr(sys, "_is_gil_enabled", None)
        if gil_check is not None and not gil_check():
            caps = IsolationCaps("free-threading", True, True, "")
        elif _si_api() is not None:
            # the probe is FUNCTIONAL, not import-sniffing: _si_api()
            # only resolves after a real interpreter + channel round
            # trip succeeded, so an API drift between CPython versions
            # (the 3.12 channel split, the 3.13 module rename) degrades
            # to the pthread fallback instead of failing per call
            if sys.version_info >= (3, 12):
                caps = IsolationCaps("subinterp", True, True, "")
            else:
                caps = IsolationCaps(
                    "subinterp-shared-gil", True, False,
                    "CPython %d.%d subinterpreters share the GIL; "
                    "per-interpreter GIL needs 3.12+ (or a "
                    "free-threading build)" % sys.version_info[:2])
        else:
            caps = IsolationCaps(
                "none", False, False,
                "no working subinterpreter+channel support in this "
                "interpreter and the GIL is enabled — isolated "
                "handlers fall back to the backup thread pool")
        _caps = caps
        return caps


# Subinterpreter compat layer: (create, destroy, run_string,
# channel_create, channel_destroy, channel_send, channel_recv).
# CPython moved these around — 3.8-3.11 keep everything in
# _xxsubinterpreters; 3.12 split channels into _xxinterpchannels
# (send/recv without the channel_ prefix); 3.13 renamed the modules
# again.  Resolution is validated by a REAL round trip (create an
# interpreter, run a string that sends through a channel, receive it),
# so a layout this shim doesn't know reads as "none" instead of
# breaking every call.
_si_cache = ("unresolved",)


def _si_api():
    global _si_cache
    if _si_cache != ("unresolved",):
        return _si_cache[0]
    api = None
    try:
        import _xxsubinterpreters as si
        if hasattr(si, "channel_create"):          # <= 3.11 layout
            api = (si.create, si.destroy, si.run_string,
                   si.channel_create, si.channel_destroy,
                   si.channel_send, si.channel_recv)
        else:                                      # 3.12 split layout
            import _xxinterpchannels as ch
            api = (si.create, si.destroy, si.run_string,
                   ch.create, ch.destroy, ch.send, ch.recv)
    except ImportError:
        try:                                       # 3.13+ rename
            import _interpreters as si
            import _interpchannels as ch
            api = (si.create, si.destroy, si.run_string,
                   ch.create, ch.destroy, ch.send, ch.recv)
        except ImportError:
            api = None
    if api is not None:
        # validate end to end once; any surprise → no isolation
        try:
            create, destroy, run_string, c_create, c_destroy, \
                c_send, c_recv = api
            interp = create()
            cid = c_create()
            try:
                run_string(interp, _PROBE_SCRIPT, {"_cid": cid})
                if c_recv(cid) != b"probe-ok":
                    api = None
            finally:
                try:
                    c_destroy(cid)
                    destroy(interp)
                except Exception:
                    pass
        except Exception:
            api = None
    _si_cache = (api,)
    return api


# runs inside the probe interpreter: resolve whichever channel-send
# exists THERE and echo a marker back
_PROBE_SCRIPT = """\
try:
    import _xxsubinterpreters as _m
    _send = _m.channel_send
except (ImportError, AttributeError):
    try:
        import _xxinterpchannels as _m
    except ImportError:
        import _interpchannels as _m
    _send = _m.send
_send(_cid, b"probe-ok")
"""


class _WorkerKilled(BaseException):
    """Chaos injection: simulates a worker dying mid-handler (the thread
    unwinds without completing its task)."""


class _IsoTask:
    __slots__ = ("name", "payload", "event", "result", "error",
                 "requeued", "abandoned")

    def __init__(self, name: str, payload: bytes):
        self.name = name
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.requeued = 0
        self.abandoned = False


# runs inside the worker's subinterpreter: dispatch one registered
# handler on the shared-in payload and send the tagged result back on
# the worker's channel (b"\x00" ok / b"\x01" handler error); the
# channel-send is resolved against whichever module layout exists in
# THAT interpreter (see _si_api)
_ISO_DISPATCH = """\
try:
    import _xxsubinterpreters as _m
    _send = _m.channel_send
except (ImportError, AttributeError):
    try:
        import _xxinterpchannels as _m
    except ImportError:
        import _interpchannels as _m
    _send = _m.send
try:
    _r = b"\\x00" + _handlers[_name](_in)
except BaseException as _e:
    _r = b"\\x01" + (type(_e).__name__ + ": " + str(_e)).encode()
_send(_cid, _r)
"""


class _IsoWorker:
    """One isolation worker: a thread hosting its own subinterpreter,
    draining the pool's shared isolated-task queue.  Handler sources
    exec lazily per worker (per-worker registration — nothing is shared
    between interpreters except the source string)."""

    def __init__(self, pool: "UsercodePool", wid: int):
        self.pool = pool
        self.wid = wid
        self._installed: Dict[str, int] = {}   # name -> version exec'd
        self._interp = None
        self._cid = None
        self.thread = threading.Thread(
            target=self._run, name=f"usercode-iso-{wid}", daemon=True)
        self.thread.start()

    def _ensure_interp(self):
        api = _si_api()
        if self._interp is None:
            create = api[0]
            c_create = api[3]
            self._interp = create()
            self._cid = c_create()
            api[2](self._interp, "_handlers = {}", None)
        return api

    def _run(self) -> None:
        pool = self.pool
        q_ = pool._iso_queue
        while True:
            task = q_.get()
            if task is None:             # shutdown sentinel
                self._destroy_interp()
                return
            if task.abandoned:           # caller timed out: never burn
                continue                 # a worker on an unread result
            try:
                if pool.chaos_kill_next:
                    pool.chaos_kill_next = False
                    raise _WorkerKilled()
                self._exec(task)
            except _WorkerKilled:
                pool._on_worker_death(self, task)
                return                   # the thread IS dead
            except BaseException as e:   # never kill the worker loop
                task.error = f"{type(e).__name__}: {e}"
                task.event.set()

    def _destroy_interp(self) -> None:
        if self._interp is None:
            return
        try:
            api = _si_api()
            api[4](self._cid)            # channel destroy
            api[1](self._interp)         # interpreter destroy
        except Exception:
            pass                         # teardown best-effort
        self._interp = None

    def _exec(self, task: _IsoTask) -> None:
        api = self._ensure_interp()
        run_string = api[2]
        name = task.name
        pool = self.pool
        with pool._lock:
            src = pool._iso_handlers.get(name)
            ver = pool._iso_versions.get(name, 0)
        if self._installed.get(name) != ver:
            if src is None:
                task.error = f"no isolated handler {name!r}"
                task.event.set()
                return
            run_string(self._interp,
                       src + f"\n_handlers[{name!r}] = handle", None)
            self._installed[name] = ver
        run_string(self._interp, _ISO_DISPATCH,
                   {"_in": task.payload, "_name": name,
                    "_cid": self._cid})
        raw = api[6](self._cid)          # channel recv
        if raw[:1] == b"\x00":
            task.result = raw[1:]
        else:
            task.error = raw[1:].decode()
        task.event.set()


class UsercodePool:
    """The ``usercode_in_pthread`` backup pool, extended with the
    isolation backend.  The plain surface (``submit``/``shutdown``) is
    a passthrough to a ``ThreadPoolExecutor``, so the dispatch, drain and
    admission semantics are those of a plain backup pool."""

    _GUARDED_BY = {
        "_iso_workers": "_lock",
        "_iso_handlers": "_lock",
        "_shutdown_flag": "_lock",
        "isolated_calls": "_lock",
        "contract_rejections": "_lock",
        "worker_deaths": "_lock",
        "requeues": "_lock",
    }

    def __init__(self, kind: str = "auto", workers: int = 8):
        if kind not in ("auto", "pthread", "subinterp"):
            raise ValueError(f"unknown usercode pool kind {kind!r}")
        from concurrent.futures import ThreadPoolExecutor
        self.caps = probe_isolation()
        if kind == "auto":
            kind = _default_kind
        if kind == "auto":
            if self.caps.mode == "free-threading":
                # plain threads already scale past the (absent) GIL:
                # the backup pool IS the scaling backend — isolation
                # machinery would only add copies
                kind = "pthread"
            else:
                kind = "subinterp" if self.caps.functional else "pthread"
        elif kind == "subinterp" and (not self.caps.functional
                                      or _si_api() is None):
            # explicit request: validate against the REAL round-trip
            # probe, not the capability flag (a free-threading build
            # reads functional=True without ever touching _si_api)
            raise RuntimeError(
                f"usercode pool kind 'subinterp' unavailable: "
                f"{self.caps.reason or 'subinterpreter API round trip failed'}")
        self.kind = kind
        self.workers = max(int(workers), 1)
        self._tp = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="usercode")
        self._lock = _dbg.make_lock("UsercodePool._lock")
        self._iso_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._iso_workers: list = []
        self._iso_handlers: Dict[str, str] = {}
        self._iso_versions: Dict[str, int] = {}
        self._fallback_fns: Dict[str, object] = {}
        self._shutdown_flag = False
        self._next_wid = 0
        # stats — guarded by _lock like the worker table: += on a
        # plain int is NOT atomic on the free-threading builds this
        # module targets
        self.isolated_calls = 0
        self.contract_rejections = 0
        self.worker_deaths = 0
        self.requeues = 0
        self.chaos_kill_next = False     # test hook: next task's worker dies

    # ---- the backup-pool surface ------------------------------------
    def submit(self, fn, *args):
        return self._tp.submit(fn, *args)

    def shutdown(self, wait: bool = False) -> None:
        with self._lock:
            self._shutdown_flag = True
            workers = list(self._iso_workers)
            self._iso_workers = []
        for _ in workers:
            self._iso_queue.put(None)
        # JOIN the isolation workers (bounded): each destroys its
        # subinterpreter on the way out, and a live subinterpreter at
        # process finalization is a hard abort ("PyInterpreterState_
        # Delete: remaining subinterpreters", SIGABRT) — the daemon
        # flag alone does not save us.  A worker wedged in a long
        # handler past the bound is left to its own exit (documented
        # residual risk, better than blocking stop() forever).
        deadline = time.monotonic() + 5.0
        for w in workers:
            w.thread.join(max(deadline - time.monotonic(), 0.1))
        # leftover sweep: a task that raced past the workers' exits
        # (queued behind the sentinels) fails NOW, not at its caller's
        # timeout — paired with call_isolated's locked check-and-put
        while True:
            try:
                t = self._iso_queue.get_nowait()
            except queue.Empty:
                break
            if t is not None:
                t.error = "usercode pool stopped"
                t.event.set()
        self._tp.shutdown(wait=wait)

    # ---- isolated handlers (share-nothing) ----------------------------
    @property
    def isolation_active(self) -> bool:
        """True when registered handlers actually run isolated (the
        subinterp backend); the pthread fallback runs them on backup
        threads instead — functional, GIL-bound."""
        return self.kind == "subinterp" and _si_api() is not None

    def register(self, name: str, src: str) -> None:
        """Register an isolated handler: ``src`` must be SOURCE (a
        string defining ``handle(payload: bytes) -> bytes``) — the
        share-nothing contract starts here: code crosses as text, never
        as an object."""
        if not isinstance(name, str) or not isinstance(src, str):
            with self._lock:
                self.contract_rejections += 1
            raise TypeError(
                "share-nothing contract: isolated handlers register as "
                "(name: str, src: str) — source crosses the isolation "
                f"boundary as text, got ({type(name).__name__}, "
                f"{type(src).__name__})")
        with self._lock:
            self._iso_handlers[name] = src
            # re-registration recompiles on EVERY backend: the fallback
            # cache drops its entry and the version bump makes each
            # subinterp worker reinstall past its own memoization
            self._iso_versions[name] = \
                self._iso_versions.get(name, 0) + 1
            self._fallback_fns.pop(name, None)
            spawn = self.isolation_active and not self._iso_workers \
                and not self._shutdown_flag
            if spawn:
                for _ in range(self.workers):
                    self._iso_workers.append(
                        _IsoWorker(self, self._next_wid))
                    self._next_wid += 1

    def call_isolated(self, name: str, payload,
                      timeout: Optional[float] = None) -> bytes:
        """Run a registered handler on an isolation worker; blocks the
        calling (backup) thread until the result crosses back.  Only
        bytes-like payloads cross; anything else is refused with a
        clear error — the share-nothing contract."""
        if isinstance(payload, (bytearray, memoryview)):
            payload = bytes(payload)
        elif not isinstance(payload, bytes):
            with self._lock:
                self.contract_rejections += 1
            raise TypeError(
                "share-nothing contract: isolated handler arguments "
                "cross as bytes (attachment handles as int) — got "
                f"{type(payload).__name__}; pass serialized bytes or "
                "run this handler unisolated")
        with self._lock:
            self.isolated_calls += 1
            if self._shutdown_flag:
                # stopped pool: refuse on EVERY backend — the pthread
                # fallback could still execute, but "works after
                # shutdown" is exactly the half-alive state callers
                # must not depend on
                raise RuntimeError("usercode pool stopped")
        if not self.isolation_active:
            # capability fallback: same handler SOURCE, executed on the
            # calling backup thread — functional parity, no scaling
            # (caps.reason says why).  The compiled namespace is cached
            # per name (invalidated by register), mirroring the
            # per-worker _installed memoization on the subinterp leg.
            fn = self._fallback_fns.get(name)
            if fn is None:
                with self._lock:
                    src = self._iso_handlers.get(name)
                if src is None:
                    raise KeyError(f"no isolated handler {name!r}")
                ns: dict = {}
                exec(src, ns)            # noqa: S102 — registered source
                fn = self._fallback_fns[name] = ns["handle"]
            return fn(payload)
        task = _IsoTask(name, payload)
        # check-and-enqueue under ONE lock: shutdown() flips the flag
        # under the same lock and then sweeps the queue after joining
        # the workers, so a task is either refused here or guaranteed
        # an answer (worker result, death requeue, or the sweep) —
        # never stranded behind the sentinels until the timeout
        with self._lock:
            if self._shutdown_flag:
                raise RuntimeError("usercode pool stopped")
            self._iso_queue.put(task)
        if not task.event.wait(timeout if timeout is not None else 60.0):
            # the caller stops waiting: mark the task so a worker that
            # dequeues it later drops it instead of computing a result
            # nobody reads
            task.abandoned = True
            raise TimeoutError(f"isolated handler {name!r} timed out")
        if task.error is not None:
            raise RuntimeError(task.error)
        return task.result

    def _on_worker_death(self, worker: "_IsoWorker", task: _IsoTask) -> None:
        """A worker died mid-task: requeue the in-hand task (another
        worker — or the replacement spawned here — picks it up) so the
        caller never sees the death.  A task that already died twice is
        failed rather than looped forever."""
        with self._lock:
            self.worker_deaths += 1
        log.warning("usercode isolation worker %d died mid-handler "
                    "(task %s); requeueing", worker.wid, task.name)
        with self._lock:
            try:
                self._iso_workers.remove(worker)
            except ValueError:
                pass
            replace = not self._shutdown_flag
            if replace:
                self._iso_workers.append(_IsoWorker(self, self._next_wid))
                self._next_wid += 1
        if not replace:
            # pool stopping: no worker will ever drain a requeue —
            # fail NOW instead of wedging the caller to its timeout
            task.error = "usercode pool stopped"
            task.event.set()
            return
        if task.requeued >= 2:
            task.error = "isolation worker died repeatedly"
            task.event.set()
            return
        task.requeued += 1
        with self._lock:
            self.requeues += 1
        self._iso_queue.put(task)

    # ---- observability -------------------------------------------------
    def describe(self) -> dict:
        caps = self.caps
        with self._lock:
            iso_workers = len(self._iso_workers)
            registered = sorted(self._iso_handlers)
            isolated_calls = self.isolated_calls
            contract_rejections = self.contract_rejections
            worker_deaths = self.worker_deaths
            requeues = self.requeues
        return {
            "kind": self.kind,
            "workers": self.workers,
            "isolation": {
                "mode": caps.mode,
                "functional": caps.functional,
                "scaling": caps.scaling,
                "reason": caps.reason,
            },
            "isolation_workers": iso_workers,
            "registered_isolated": registered,
            "isolated_calls": isolated_calls,
            "contract_rejections": contract_rejections,
            "worker_deaths": worker_deaths,
            "requeues": requeues,
        }
