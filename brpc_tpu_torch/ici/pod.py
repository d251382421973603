"""Pod fabric membership: join/leave/epoch over the fabric's store.

Port of :mod:`brpc_tpu.ici.pod`.  The reference's cluster is whatever its
naming services return (src/brpc/policy/*naming_service.cpp); liveness is
the health checker's and circuit breaker's concern, never the registry's.
The pod layer keeps that division of labor across processes:

  * **Membership** — every process that joined the pod publishes a member
    record under ``brpc_tpu/pod/<name>/<pid>`` in the ``TCPStore`` the
    fabric handshake uses (:class:`~.fabric.FabricNode`): its owned ranks,
    the ranks it is currently SERVING (a Server bound to ``ici://k``), the
    ones draining (lame duck), and a per-member generation counter bumped
    on every transition.  The store lists no directory, so the pod is read
    as the keys ``…/<pid>`` for every process of the fabric: a ``check``
    for a process not yet seen, then one ``multi_get`` of every known
    record (a record is never deleted: ``leave`` leaves a tombstone).
  * **Epoch** — the pod epoch is the SUM of member generations: every
    join / advertise / drain / withdraw / rejoin bumps exactly one gen, so
    the epoch strictly increases on every membership transition and every
    process computes the SAME epoch for the same set of records.
  * **Liveness** — deliberately NOT here.  A member that crashes cannot
    update its record; its endpoints are discovered dead by the existing
    machinery (connect failures hand the endpoint to the health checker,
    balancers exclude it) and revived the same way.  GOODBYE remains the
    per-socket drain signal; the pod record is the membership drain signal
    that also reaches processes holding no socket to the drainer.

``pod://<name>`` (:mod:`..policy.naming`) turns the member table into a
server list — every serving, non-draining rank of every up member — so
any balanced channel (``Channel.init("pod://default", "rr")``) balances
over the pod, and the per-pair fabric sockets are made lazily by
:func:`~.fabric.connect_any` on first use.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..butil import flags as _flags
from ..butil import logging as log
from ..butil.endpoint import EndPoint

_flags.define_flag("ici_pod_watch_interval_s", 0.25,
                   "pod membership watch poll period")

_KV_POD_PREFIX = "brpc_tpu/pod/"

UP = "up"
DRAINING = "draining"
DOWN = "down"


class PodMember:
    """One member record as read from the store (a snapshot).  ``coll``
    lists the method names this member registered device-side handlers
    for (``Server.register_collective``); ``load`` is its published
    serving load in [0, 1] — telemetry, not membership: a load change
    bumps no gen."""

    __slots__ = ("pid", "gen", "state", "devices", "serving", "draining",
                 "ctrl", "ts", "coll", "load")

    def __init__(self, pid: int, gen: int, state: str,
                 devices: List[int], serving: List[int],
                 draining: List[int], ctrl: str = "", ts: float = 0.0,
                 coll: Optional[List[str]] = None, load: float = 0.0):
        self.pid = pid
        self.gen = gen
        self.state = state
        self.devices = devices
        self.serving = serving
        self.draining = draining
        self.ctrl = ctrl
        self.ts = ts
        self.coll = coll or []
        self.load = load

    @classmethod
    def from_json(cls, raw: str) -> "PodMember":
        d = json.loads(raw)
        return cls(d["pid"], d["gen"], d.get("state", UP),
                   d.get("devices", []), d.get("serving", []),
                   d.get("draining", []), d.get("ctrl", ""),
                   d.get("ts", 0.0), d.get("coll", []),
                   d.get("load", 0.0))

    def to_json(self) -> str:
        return json.dumps({
            "pid": self.pid, "gen": self.gen, "state": self.state,
            "devices": self.devices, "serving": self.serving,
            "draining": self.draining, "ctrl": self.ctrl, "ts": self.ts,
            "coll": self.coll, "load": self.load,
        })

    def describe(self) -> dict:
        return {"pid": self.pid, "gen": self.gen, "state": self.state,
                "devices": self.devices, "serving": self.serving,
                "draining": self.draining, "coll": self.coll,
                "load": self.load}


def _store_closed(node) -> bool:
    """The node quiesced: no thread may enter the store (a daemon thread
    inside a torch call when the interpreter finalizes aborts it)."""
    return bool(getattr(node, "_store_closed", False))


def epoch_of(members: Dict[int, PodMember]) -> int:
    """The convergent pod epoch for a membership snapshot: the sum of
    member generations."""
    return sum(m.gen for m in members.values())


class Pod:
    """Per-process pod runtime: the local member record and a membership
    watch.  One pod per process (the FabricNode discipline).

    Locks: ``_publish_lock`` is taken before ``_lock``, never the reverse.
    ``_lock`` guards the local record, the cached membership view, the
    watchers and the attached autoscaler."""

    _instance: Optional["Pod"] = None
    _ilock = threading.Lock()

    def __init__(self, name: str, node) -> None:
        self.name = name
        self.node = node                    # FabricNode
        self.pid = node.process_id
        self._store = node._store
        self._store_lock = node._store_lock
        self._lock = threading.Lock()
        self._publish_lock = threading.Lock()
        self._gen = 0
        self._state = DOWN
        self._serving: List[int] = []
        self._draining_devs: List[int] = []
        self._coll: List[str] = []
        self._load = 0.0
        self._autoscaler = None
        self._members: Dict[int, PodMember] = {}
        self._known: List[int] = []         # pids whose record exists
        self._watchers: List[Callable[[Dict[int, PodMember]], None]] = []
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._devices = list(node.devices)
        self._refresh_warned_at = 0.0

    # ---- lifecycle -----------------------------------------------------
    @classmethod
    def current(cls) -> Optional["Pod"]:
        with cls._ilock:
            return cls._instance

    @classmethod
    def join(cls, name: str = "default") -> "Pod":
        """Join (or return the already-joined) pod.  Requires a live
        FabricNode: the pod lives on the store its handshake uses."""
        from .fabric import FabricNode
        node = FabricNode.instance()
        if node is None:
            raise RuntimeError("Pod.join requires FabricNode.initialize "
                               "(the pod lives on the fabric's store)")
        with cls._ilock:
            if cls._instance is not None:
                if cls._instance.name != name:
                    raise RuntimeError(
                        f"process already joined pod "
                        f"{cls._instance.name!r}, cannot join {name!r}")
                return cls._instance
            pod = Pod(name, node)
            cls._instance = pod
        try:
            pod._join()
        except BaseException:
            # a store hiccup mid-join must not leave a half-joined
            # singleton that every later join() returns as-is
            with cls._ilock:
                if cls._instance is pod:
                    cls._instance = None
            raise
        return pod

    def _join(self) -> None:
        # Resume from a surviving record before bumping: a rejoin after
        # leave() (tombstone) must not overwrite a high gen with 1 — the
        # epoch is the sum of gens and may never regress
        prior = self._refresh().get(self.pid)
        # collective capability registered before the join rides the
        # join's publish
        try:
            from ..channels.collective_fanout import registry as _cfreg
            coll = _cfreg().method_names()
        except Exception:
            coll = []
        with self._lock:
            if prior is not None and prior.gen > self._gen:
                self._gen = prior.gen
            self._gen += 1
            self._state = UP
            if coll:
                self._coll = coll
        self._publish()
        self._refresh()
        t = threading.Thread(target=self._watch_loop,
                             name=f"pod_watch:{self.name}", daemon=True)
        self._watch_thread = t
        t.start()
        log.info("pod %s: process %d joined (epoch %d)", self.name,
                 self.pid, self.epoch())

    def leave(self) -> None:
        """Leave the pod: publish state=down (epoch bump) and stop the
        watch thread.  The record stays in the store as a tombstone so
        the epoch never regresses for the remaining members."""
        with self._lock:
            if self._state == DOWN:
                return
            self._gen += 1
            self._state = DOWN
            self._serving = []
            self._draining_devs = []
        self._publish()
        self._stop.set()
        t = self._watch_thread
        if t is not None and t is not threading.current_thread():
            t.join(2.0)
        with Pod._ilock:
            if Pod._instance is self:
                Pod._instance = None

    # ---- local record --------------------------------------------------
    def _publish(self) -> None:
        # _publish_lock covers the snapshot AND the store write: two
        # concurrent transitions must commit their records in snapshot
        # order, or the stale snapshot lands last and a gen bump is lost
        with self._publish_lock:
            with self._lock:
                rec = PodMember(self.pid, self._gen, self._state,
                                list(self._devices), list(self._serving),
                                list(self._draining_devs),
                                ctrl=self.node.ctrl_addr, ts=time.time(),
                                coll=list(self._coll), load=self._load)
            with self._store_lock:
                if _store_closed(self.node):
                    return
                self._store.set(self._key(self.pid), rec.to_json())

    def _key(self, pid: int) -> str:
        return f"{_KV_POD_PREFIX}{self.name}/{pid}"

    def advertise(self, device_id: int) -> None:
        """A server came up on ``ici://device_id`` in this process: add it
        to the serving set.  Always bumps the gen, even when the rank is
        already listed — a killed member whose record still says
        "serving" re-advertises on revival, and the bump is what lets
        every watcher observe the rejoin."""
        with self._lock:
            if device_id not in self._serving:
                self._serving.append(device_id)
            if device_id in self._draining_devs:
                self._draining_devs.remove(device_id)
            self._gen += 1
            self._state = UP
        self._publish()

    def withdraw(self, device_id: int) -> None:
        """The server on ``ici://device_id`` stopped: drop it from the
        serving set (epoch bump).  Idempotent."""
        with self._lock:
            if device_id not in self._serving \
                    and device_id not in self._draining_devs:
                return
            if device_id in self._serving:
                self._serving.remove(device_id)
            if device_id in self._draining_devs:
                self._draining_devs.remove(device_id)
            self._gen += 1
        self._publish()

    def publish_collective(self, methods: List[str]) -> None:
        """Advertise the process's registered device-side handler methods
        (the compiled fan-out's capability).  A no-op when nothing
        changed; otherwise a gen bump."""
        with self._lock:
            if methods == self._coll:
                return
            self._coll = list(methods)
            self._gen += 1
        self._publish()

    def publish_load(self, load: float) -> None:
        """Publish the member's serving load (clamped to [0, 1]) into its
        record — telemetry for the autoscaler, not a membership
        transition: the gen does not bump and watchers do not fire."""
        load = min(max(float(load), 0.0), 1.0)
        with self._lock:
            if abs(load - self._load) < 1e-9:
                return
            self._load = load
        self._publish()

    def loads(self, refresh: bool = False) -> Dict[int, float]:
        """Every up member's published load."""
        return {m.pid: m.load for m in
                self.members(refresh=refresh).values()
                if m.state == UP}

    def attach_autoscaler(self, autoscaler) -> None:
        """Register the autoscaler driving this member's scale decisions;
        it appears in :meth:`describe` (the ``/ici`` page's pod block)."""
        with self._lock:
            self._autoscaler = autoscaler

    def mark_draining(self, device_id: int) -> None:
        """Lame duck: the server on ``ici://device_id`` began its drain
        window.  The rank stays in the record (the member is up) but
        ``pod://`` stops listing it."""
        with self._lock:
            if device_id in self._draining_devs:
                return
            self._draining_devs.append(device_id)
            self._gen += 1
        self._publish()

    def evict(self, pid: int) -> bool:
        """Tombstone another member that cannot leave by itself: its
        process died.  Its record is republished down, serving nothing,
        with its gen bumped, so every member's epoch moves and its ranks
        leave ``pod://`` and the fan-out's screen.  The pod keeps no
        liveness of its own: the caller (a supervisor, or a member that
        saw the process exit) decides.  False when there is no such live
        record."""
        if pid == self.pid:
            raise ValueError("a member leaves by itself: Pod.leave()")
        rec = self._refresh().get(pid)
        if rec is None or rec.state == DOWN:
            return False
        dead = PodMember(pid, rec.gen + 1, DOWN, rec.devices, [], [],
                         ctrl=rec.ctrl, ts=time.time(), coll=rec.coll,
                         load=0.0)
        with self._store_lock:
            if _store_closed(self.node):
                return False
            self._store.set(self._key(pid), dead.to_json())
        log.warning("pod %s: process %d evicted", self.name, pid)
        self._refresh()
        return True

    # ---- membership view -----------------------------------------------
    def _read_records(self) -> List[str]:
        """Every member record of the pod: a ``check`` per process not yet
        seen, then one ``multi_get`` of the known records (the steady
        state is one round trip)."""
        num = max(int(getattr(self.node, "num_processes", 0)), self.pid + 1)
        with self._store_lock:
            if _store_closed(self.node):
                raise ConnectionError("the fabric node is shut down")
            for pid in range(num):
                if pid not in self._known \
                        and self._store.check([self._key(pid)]):
                    self._known.append(pid)
            keys = [self._key(pid) for pid in sorted(self._known)]
            raw = self._store.multi_get(keys) if keys else []
        return [r.decode() if isinstance(r, bytes) else r for r in raw]

    def _refresh(self) -> Dict[int, PodMember]:
        """Read every member record from the store."""
        try:
            records = self._read_records()
        except Exception as e:
            now = time.monotonic()
            if now - self._refresh_warned_at > 60.0:
                self._refresh_warned_at = now
                log.warning("pod %s: store read failed: %s", self.name, e)
            with self._lock:
                return dict(self._members)
        fresh: Dict[int, PodMember] = {}
        for raw in records:
            try:
                m = PodMember.from_json(raw)
            except Exception:
                continue
            fresh[m.pid] = m
        with self._lock:
            self._members = fresh
            return dict(fresh)

    def members(self, refresh: bool = False) -> Dict[int, PodMember]:
        if refresh:
            return self._refresh()
        with self._lock:
            return dict(self._members)

    def epoch(self, refresh: bool = False) -> int:
        return epoch_of(self.members(refresh=refresh))

    def serving_endpoints(self) -> List[Tuple[EndPoint, int]]:
        """(endpoint, owner pid) for every serving, non-draining rank of
        every up member — the ``pod://`` naming source."""
        mesh = self.node.mesh
        out: List[Tuple[EndPoint, int]] = []
        for m in sorted(self.members().values(), key=lambda m: m.pid):
            if m.state != UP:
                continue
            for dev in m.serving:
                if dev in m.draining:
                    continue
                out.append((mesh.endpoint(dev), m.pid))
        return out

    def wait_epoch(self, at_least: int, timeout: float = 30.0) -> int:
        """Block until the pod epoch reaches ``at_least`` (refreshing),
        returning the epoch observed; raises TimeoutError past the
        deadline.  The N-process convergence primitive."""
        deadline = time.monotonic() + timeout
        while True:
            e = self.epoch(refresh=True)
            if e >= at_least:
                return e
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"pod {self.name}: epoch {e} < {at_least} "
                    f"after {timeout}s")
            time.sleep(0.05)

    def add_watcher(self,
                    fn: Callable[[Dict[int, PodMember]], None]) -> None:
        """``fn(members)`` runs on the watch thread after every observed
        membership change (the epoch moved)."""
        with self._lock:
            self._watchers.append(fn)

    # ---- watch loop ----------------------------------------------------
    def _watch_loop(self) -> None:
        last_epoch = -1
        while not self._stop.wait(
                _flags.get_flag("ici_pod_watch_interval_s")):
            members = self._refresh()
            e = epoch_of(members)
            if e == last_epoch:
                continue
            last_epoch = e
            with self._lock:
                watchers = list(self._watchers)
            for fn in watchers:
                try:
                    fn(members)
                except Exception:
                    log.error("pod %s: watcher failed", self.name,
                              exc_info=True)

    # ---- observability -------------------------------------------------
    def describe(self) -> dict:
        members = self.members()
        out = {
            "name": self.name,
            "pid": self.pid,
            "epoch": epoch_of(members),
            "members": [members[p].describe()
                        for p in sorted(members)],
        }
        with self._lock:
            autoscaler = self._autoscaler
        if autoscaler is not None:
            try:
                out["autoscaler"] = autoscaler.describe()
            except Exception:
                pass
        return out


# ---- server lifecycle hooks (rpc/server.py) ----------------------------
# No-ops when no pod is joined: a plain fabric (or a mem:// server) never
# touches the pod layer.  A failed store write is logged, never raised
# into the server's start or stop.

def _on_server(ep: EndPoint, transition: str) -> None:
    pod = Pod.current()
    if pod is None or ep is None or ep.scheme != "ici" \
            or len(ep.coords) != 1:
        return
    try:
        getattr(pod, transition)(ep.device_id)
    except Exception as e:
        log.warning("pod %s: %s of %s failed: %s", pod.name, transition,
                    ep, e)


def on_server_started(ep: EndPoint) -> None:
    _on_server(ep, "advertise")


def on_server_draining(ep: EndPoint) -> None:
    _on_server(ep, "mark_draining")


def on_server_stopped(ep: EndPoint) -> None:
    _on_server(ep, "withdraw")
