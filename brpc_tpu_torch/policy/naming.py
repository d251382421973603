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

and its remote schemes, fetched over HTTP with the standard library:

  * ``dns://host:port``         the host's IPv4 addresses, resolved each
                                period (the reference's DomainNamingService;
                                ``http://`` and ``https://`` alike)
  * ``consul://host:port/name`` Consul's health API with its blocking
                                watch: the first GET primes the index from
                                ``X-Consul-Index``, each later round
                                long-polls ``?index=<last>&wait=60s``; a
                                plain JSON list of ``"host:port"`` strings
                                (which may name ``ici://`` ranks) is taken
                                too, and with no index the thread polls
  * ``remotefile://host/path``  a list file fetched over HTTP, one
                                ``endpoint [weight] [tag]`` a line
  * ``nacos://host:port/svc``   Nacos' instance list: unhealthy and
                                disabled hosts dropped, weight x 100,
                                ``clusterName`` as the tag
  * ``discovery://host:port/app`` Bilibili discovery: status 1 only,
                                every address of an instance, ``zone`` as
                                the tag

A NamingServiceThread polls its source and pushes full server lists to
watchers (load balancers implement the watcher interface via
``reset_servers``); a source that watches (consul) is instead re-asked
the moment its long poll returns.  ``stop`` shuts the socket of a held
poll, so it returns within its timeout rather than after the poll's 75 s.
"""
from __future__ import annotations

import http.client
import json
import socket as _pysocket
import threading
import urllib.request
from typing import Dict, List, Optional

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil import flags as _flags
from ..butil import logging as log
from .load_balancers import ServerEntry

_flags.define_flag("ns_poll_interval_s", 1.0,
                   "naming service polling period")


class NamingService:
    def get_servers(self) -> List[ServerEntry]:
        raise NotImplementedError

    def supports_watch(self) -> bool:
        return False

    def watch(self) -> List[ServerEntry]:
        """One blocking watch round (sources with supports_watch()):
        returns when membership changed or the source's hold elapsed."""
        return self.get_servers()

    def cancel(self) -> None:
        """End a fetch in flight, and refuse later ones (the thread's
        ``stop``)."""


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


def resolve_servers(target: str) -> List[str]:
    """One endpoint url per resolved server, the resolver that rpc_press
    and rpc_view share: a naming url resolves through its naming service,
    a comma-separated list is split (the parens of ici mesh coords kept
    whole), a single endpoint passes through.  An empty resolution raises
    ValueError, so a mistyped pod name never targets nothing."""
    # a comma list whose first entry is a bare host:port and a later one a
    # scheme ("127.0.0.1:80,mem://x") holds "://" too; a naming url's
    # scheme (before its first "://") never holds a comma
    if is_naming_url(target) and "," not in target.split("://", 1)[0]:
        out = [str(e.endpoint)
               for e in create_naming_service(target).get_servers()]
        if not out:
            raise ValueError(f"{target} resolved to no servers")
        return out
    if "," in target:
        out = _split_list(target)
        if not out:
            raise ValueError(f"empty server list {target!r}")
        return out
    return [target]


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


class _HttpFetcher:
    """GETs through urllib that ``cancel`` can end: the HTTP connection's
    socket is kept while its request is in flight, and ``cancel`` shuts it,
    which wakes a read held by a long poll at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._socks = set()
        self._cancelled = False
        fetcher = self

        class _Conn(http.client.HTTPConnection):
            def connect(self):
                super().connect()
                with fetcher._lock:
                    if fetcher._cancelled:
                        self.sock.close()
                        raise ConnectionError("naming fetch cancelled")
                    fetcher._socks.add(self.sock)

        class _Handler(urllib.request.HTTPHandler):
            def http_open(self, req):
                return self.do_open(_Conn, req)

        self._opener = urllib.request.build_opener(_Handler)

    def get(self, url: str, timeout: float):
        """``(headers, body bytes)`` of one GET."""
        try:
            with self._opener.open(url, timeout=timeout) as r:
                return r.headers, r.read()
        finally:
            with self._lock:        # urllib closed the finished ones
                self._socks = {sk for sk in self._socks
                               if sk.fileno() != -1}

    def cancel(self) -> None:
        with self._lock:
            self._cancelled = True
            socks = list(self._socks)
        for sk in socks:
            try:
                sk.shutdown(_pysocket.SHUT_RDWR)
            except OSError:
                pass


class DnsNamingService(NamingService):
    def __init__(self, hostport: str):
        host, _, port = hostport.rpartition(":")
        self.host = host
        self.port = int(port)

    def get_servers(self) -> List[ServerEntry]:
        infos = _pysocket.getaddrinfo(self.host, self.port,
                                      _pysocket.AF_INET,
                                      _pysocket.SOCK_STREAM)
        eps = sorted({info[4][0] for info in infos})
        return [ServerEntry(EndPoint(scheme="tcp", host=ip, port=self.port))
                for ip in eps]


class _HttpNamingService(NamingService):
    def __init__(self):
        self._http = _HttpFetcher()

    def cancel(self) -> None:
        self._http.cancel()

    def _get_json(self, url: str, timeout: float = 5.0):
        return json.loads(self._http.get(url, timeout)[1].decode())


class ConsulNamingService(_HttpNamingService):
    """Consul's health API with the blocking long-poll watch (reference
    policy/consul_naming_service.cpp:99-114): the first GET primes the
    index from the ``X-Consul-Index`` header, and every later round
    long-polls ``.../v1/health/service/<name>?index=<last>&wait=60s``,
    which the server holds until membership moves past <last> (or the
    wait elapses), so a change arrives in one round trip rather than one
    polling period.  A plain JSON list of ``"host:port"`` strings is taken
    as well (generic HTTP discovery); it has no index, so the thread
    polls it."""

    WAIT = "60s"            # consul's hold; the client's timeout adds slack

    def __init__(self, rest: str):
        super().__init__()
        hostport, _, name = rest.partition("/")
        self.url = f"http://{hostport}/v1/health/service/{name}"
        self.last_index: Optional[str] = None

    def supports_watch(self) -> bool:
        return True

    def _fetch(self, url: str, timeout: float):
        headers, body = self._http.get(url, timeout)
        return headers.get("X-Consul-Index"), json.loads(body.decode())

    @staticmethod
    def parse_health_response(data) -> List[ServerEntry]:
        out = []
        for item in data:
            if isinstance(item, str):
                out.append(ServerEntry(parse_endpoint(item)))
            else:
                svc = item.get("Service", {})
                out.append(ServerEntry(
                    EndPoint(scheme="tcp", host=svc.get("Address", ""),
                             port=int(svc.get("Port", 0))),
                    tag=",".join(svc.get("Tags") or [])))
        return out

    def get_servers(self) -> List[ServerEntry]:
        idx, data = self._fetch(self.url, timeout=5)
        if idx:
            self.last_index = idx
        return self.parse_health_response(data)

    def watch(self) -> List[ServerEntry]:
        if self.last_index is None:
            return self.get_servers()        # prime the index first
        url = f"{self.url}?index={self.last_index}&wait={self.WAIT}"
        idx, data = self._fetch(url, timeout=75.0)
        if idx:
            self.last_index = idx
        return self.parse_health_response(data)


class RemoteFileNamingService(_HttpNamingService):
    """``remotefile://<url without its scheme>``: a server list fetched
    over HTTP, one ``endpoint [weight] [tag]`` a line
    (policy/remote_file_naming_service.cpp)."""

    def __init__(self, rest: str):
        super().__init__()
        self.url = rest if rest.startswith(("http://", "https://")) \
            else f"http://{rest}"

    def get_servers(self) -> List[ServerEntry]:
        body = self._http.get(self.url, 5)[1].decode()
        out = []
        for line in body.splitlines():
            e = _parse_line(line)
            if e is not None:
                out.append(e)
        return out


class NacosNamingService(_HttpNamingService):
    """``nacos://host:port/serviceName[?namespaceId=..&groupName=..]``:
    Nacos' open API GET /nacos/v1/ns/instance/list
    (policy/nacos_naming_service.cpp).  Unhealthy and disabled hosts are
    dropped; a weight scales the default 100."""

    def __init__(self, rest: str):
        super().__init__()
        hostport, _, svc = rest.partition("/")
        name, _, query = svc.partition("?")
        q = f"serviceName={name}" + (f"&{query}" if query else "")
        self.url = f"http://{hostport}/nacos/v1/ns/instance/list?{q}"

    def get_servers(self) -> List[ServerEntry]:
        out = []
        for h in self._get_json(self.url).get("hosts", []):
            if not h.get("healthy", True) or not h.get("enabled", True):
                continue
            out.append(ServerEntry(
                EndPoint(scheme="tcp", host=str(h.get("ip", "")),
                         port=int(h.get("port", 0))),
                weight=int(float(h.get("weight", 1.0)) * 100),
                tag=str(h.get("clusterName", ""))))
        return out


class DiscoveryNamingService(_HttpNamingService):
    """``discovery://host:port/appid[?env=..&status=1]``: Bilibili
    discovery's GET /discovery/fetchs
    (policy/discovery_naming_service.cpp).  Instances of status 1 only,
    one entry per address, the zone as the tag."""

    def __init__(self, rest: str):
        super().__init__()
        hostport, _, app = rest.partition("/")
        self.appid, _, query = app.partition("?")
        q = f"appid={self.appid}" + (f"&{query}" if query else
                                     "&env=prod&status=1")
        self.url = f"http://{hostport}/discovery/fetchs?{q}"

    def get_servers(self) -> List[ServerEntry]:
        data = self._get_json(self.url)
        out = []
        app = data.get("data", {}).get(self.appid, {})
        for inst in app.get("instances", []):
            if inst.get("status", 1) != 1:
                continue
            for addr in inst.get("addrs", []):
                _, _, hp = addr.partition("://")
                host, _, port = hp.rpartition(":")
                if host and port.isdigit():
                    out.append(ServerEntry(
                        EndPoint(scheme="tcp", host=host, port=int(port)),
                        tag=str(inst.get("zone", ""))))
        return out


def create_naming_service(url: str) -> NamingService:
    scheme, _, rest = url.partition("://")
    if scheme == "list":
        return ListNamingService(rest)
    if scheme == "file":
        return FileNamingService(rest)
    if scheme in ("dns", "http", "https"):
        return DnsNamingService(rest)
    if scheme == "mesh":
        return MeshNamingService()
    if scheme == "pod":
        return PodNamingService(rest)
    if scheme == "consul":
        return ConsulNamingService(rest)
    if scheme == "remotefile":
        return RemoteFileNamingService(rest)
    if scheme == "nacos":
        return NacosNamingService(rest)
    if scheme == "discovery":
        return DiscoveryNamingService(rest)
    raise ValueError(f"unknown naming service scheme {scheme!r}")


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
        if self.ns.supports_watch():
            self._watch_loop()
            return
        while not self._stop.wait(_flags.get_flag("ns_poll_interval_s")):
            self._poll_once()

    def _watch_loop(self) -> None:
        """Each round holds a long poll at the source and publishes the
        moment it returns.  After an error the next round waits one
        polling period, so a registry that is down is not hammered; a
        source that answered without an index is polled at that period
        rather than re-asked at once."""
        period = lambda: _flags.get_flag("ns_poll_interval_s")  # noqa: E731
        while not self._stop.is_set():
            try:
                entries = self.ns.watch()
            except Exception as e:
                if self._stop.is_set():
                    return
                if not self._failing:
                    log.warning("naming watch %s failed: %s", self.url, e)
                self._failing = True
                if self._stop.wait(period()):
                    return
                continue
            self._failing = False
            self._publish(entries)
            if getattr(self.ns, "last_index", "armed") is None \
                    and self._stop.wait(period()):
                return

    def stop(self, timeout: float = 2.0) -> None:
        """Stop polling; a long poll in flight is ended by shutting its
        socket, so this returns within ``timeout``."""
        self._stop.set()
        self.ns.cancel()
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


def stop_naming_service_thread(url: str, timeout: float = 2.0) -> None:
    """Stop the shared thread of ``url`` and forget it: a later Channel
    on that url starts a new one."""
    with _threads_lock:
        t = _threads.pop(url, None)
    if t is not None:
        t.stop(timeout)
