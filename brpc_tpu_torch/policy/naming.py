"""Naming services: cluster membership sources.

Reference: src/brpc/policy/*naming_service.cpp + details/
naming_service_thread.h (one shared polling thread per url), ported from
:mod:`brpc_tpu.policy.naming` with its static and mesh schemes:

  * ``list://ep1,ep2,...``      static list (tags via ``ep weight tag``)
  * ``file://path``             one endpoint per line, re-read each period;
                                ``endpoint weight tag`` columns, with the
                                "N/M" partition tags PartitionChannel
                                parses (partition_channel.h:46-52)
  * ``mesh://``                 every rank of the default mesh, minus the
                                ones draining (:mod:`..rpc.lameduck`)
  * ``pod://<name>``            pod membership (:mod:`..ici.pod`): every
                                serving, non-draining rank of every up
                                member; join, leave and drain transitions
                                move the pod epoch and show at the next
                                poll

A NamingServiceThread polls its source and pushes full server lists to
watchers (load balancers implement the watcher interface via
``reset_servers``).  The remote schemes (``dns://``, ``consul://``,
``nacos://``, ``discovery://``, remote file) are not ported yet.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..butil.endpoint import parse_endpoint
from ..butil import flags as _flags
from ..butil import logging as log
from .load_balancers import ServerEntry

_flags.define_flag("ns_poll_interval_s", 1.0,
                   "naming service polling period")


class NamingService:
    def get_servers(self) -> List[ServerEntry]:
        raise NotImplementedError


def _parse_line(line: str) -> Optional[ServerEntry]:
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    parts = line.split()
    ep = parse_endpoint(parts[0])
    weight = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 100
    tag = parts[-1] if len(parts) > 1 and not parts[-1].isdigit() else ""
    return ServerEntry(ep, weight, tag)


def _split_list(body: str) -> List[str]:
    """Split a list:// body on commas, but not inside ici mesh coords:
    ``list://ici://(0,1),ici://(0,2)`` is two entries, not four.  Spaces
    inside the parens are squeezed out so ``_parse_line`` sees
    ``ici://(0,1)`` as one token."""
    out, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        elif ch.isspace() and depth > 0:
            continue
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [x for x in out if x.strip()]


def is_naming_url(target: str) -> bool:
    """True when ``target`` is a naming-service url (``list://``,
    ``file://``, ``mesh://``, ``pod://``, ...) rather than a direct
    endpoint."""
    return "://" in target and not target.startswith(
        ("mem://", "ici://", "tcp://"))


class ListNamingService(NamingService):
    def __init__(self, body: str):
        self._entries = []
        for item in _split_list(body):
            e = _parse_line(item.replace(":tag=", " "))
            if e is not None:
                self._entries.append(e)

    def get_servers(self) -> List[ServerEntry]:
        return list(self._entries)


class FileNamingService(NamingService):
    def __init__(self, path: str):
        self.path = path

    def get_servers(self) -> List[ServerEntry]:
        out = []
        with open(self.path) as f:
            for line in f:
                e = _parse_line(line)
                if e is not None:
                    out.append(e)
        return out


class MeshNamingService(NamingService):
    """The default mesh's ranks as membership: ``ici://0..n-1``, each
    tagged with its device, minus the draining ones (a local server in
    its drain window, or a peer that sent GOODBYE)."""

    def get_servers(self) -> List[ServerEntry]:
        from ..ici.mesh import IciMesh
        from ..rpc import lameduck
        mesh = IciMesh.default()
        out = []
        for i in range(mesh.size):
            ep = mesh.endpoint(i)
            if lameduck.is_draining(ep):
                continue
            out.append(ServerEntry(ep, 100, tag=str(mesh.device(i))))
        return out


class PodNamingService(NamingService):
    """``pod://<name>``: the pod's member table as a server list — every
    serving, non-draining rank of every up member, tagged ``pid=<pid>``.
    Membership is the record; liveness stays with the health checker and
    circuit breakers.  A process that has not joined the pod gets an empty
    list (and one warning) rather than an error: membership may begin
    later."""

    def __init__(self, name: str):
        self.pod_name = name or "default"
        self._warned = False

    def get_servers(self) -> List[ServerEntry]:
        from ..ici.pod import Pod
        pod = Pod.current()
        if pod is None or pod.name != self.pod_name:
            if not self._warned:
                self._warned = True
                log.warning("pod://%s: this process has not joined the "
                            "pod; membership is empty until Pod.join",
                            self.pod_name)
            return []
        from ..rpc import lameduck
        out = []
        for ep, pid in pod.serving_endpoints():
            if lameduck.is_draining(ep):
                continue            # GOODBYE beat the membership record
            out.append(ServerEntry(ep, 100, tag=f"pid={pid}"))
        return out


def create_naming_service(url: str) -> NamingService:
    scheme, _, rest = url.partition("://")
    if scheme == "list":
        return ListNamingService(rest)
    if scheme == "file":
        return FileNamingService(rest)
    if scheme == "mesh":
        return MeshNamingService()
    if scheme == "pod":
        return PodNamingService(rest)
    raise ValueError(f"unknown naming service scheme {scheme!r}: the port "
                     "resolves list://, file://, mesh:// and pod://")


class NamingServiceThread:
    """Shared per-url poller (details/naming_service_thread.h:58).  The
    first poll runs in the constructor, so a watcher added right after
    sees the membership at once."""

    def __init__(self, url: str):
        self.url = url
        self.ns = create_naming_service(url)
        self._watchers: List = []
        self._lock = threading.Lock()
        self._last: List[ServerEntry] = []
        self._have_last = False
        self._failing = False           # the last poll raised (logged once)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name=f"ns:{url[:24]}", daemon=True)
        self._poll_once()
        self._thread.start()

    def add_watcher(self, watcher) -> None:
        """watcher has reset_servers(List[ServerEntry])."""
        with self._lock:
            self._watchers.append(watcher)
            if self._have_last:
                watcher.reset_servers(self._last)

    def remove_watcher(self, watcher) -> None:
        with self._lock:
            try:
                self._watchers.remove(watcher)
            except ValueError:
                pass

    def servers(self) -> List[ServerEntry]:
        with self._lock:
            return list(self._last)

    def _poll_once(self) -> None:
        try:
            entries = self.ns.get_servers()
        except Exception as e:
            if not self._failing:
                log.warning("naming %s failed: %s", self.url, e)
            self._failing = True
            return
        self._failing = False
        self._publish(entries)

    def _publish(self, entries: List[ServerEntry]) -> None:
        with self._lock:
            changed = (not self._have_last
                       or [(str(e.endpoint), e.weight, e.tag) for e in entries]
                       != [(str(e.endpoint), e.weight, e.tag)
                           for e in self._last])
            self._last = entries
            self._have_last = True
            watchers = list(self._watchers)
        if changed:
            for w in watchers:
                try:
                    w.reset_servers(entries)
                except Exception:
                    log.error("naming watcher of %s raised", self.url,
                              exc_info=True)

    def _run(self) -> None:
        while not self._stop.wait(_flags.get_flag("ns_poll_interval_s")):
            self._poll_once()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


_threads: Dict[str, NamingServiceThread] = {}
_threads_lock = threading.Lock()


def get_naming_service_thread(url: str) -> NamingServiceThread:
    with _threads_lock:
        t = _threads.get(url)
        if t is None:
            t = NamingServiceThread(url)
            _threads[url] = t
        return t
