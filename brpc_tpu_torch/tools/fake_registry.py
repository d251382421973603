"""A registry on localhost that answers the remote naming schemes' HTTP
APIs, for tests and ``chip_smoke.py``'s phase 22.

One ``ThreadingHTTPServer`` on ``127.0.0.1`` serves:

  * Consul's ``/v1/health/service/<name>``, in either form: the health
    API's list (``X-Consul-Index`` set, a poll carrying the current
    ``index=`` held until the index moves or the hold ends) or a plain
    JSON list of ``"host:port"`` strings with no index;
  * a list file at any other path (``remotefile://``);
  * Nacos' ``/nacos/v1/ns/instance/list?serviceName=``;
  * Bilibili discovery's ``/discovery/fetchs?appid=``.

Every request is logged in ``queries`` as ``(monotonic time, path, query
dict)``; ``fail_next(n)`` answers the next ``n`` requests with 500.

Usage::

    reg = FakeRegistry()
    reg.set_consul("web", [reg.consul_item("127.0.0.1", 8000)])
    ch.init(f"consul://{reg.hostport}/web", "rr")
    reg.set_consul("web", [...])          # bumps the index: the watch
    reg.close()                           # returns at once
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

CONSUL_PREFIX = "/v1/health/service/"
NACOS_PATH = "/nacos/v1/ns/instance/list"
DISCOVERY_PATH = "/discovery/fetchs"


class FakeRegistry:
    HOLD_S = 60.0           # Consul's hold of a poll on the current index

    def __init__(self):
        self.lock = threading.Lock()
        self.queries: List[tuple] = []
        self._consul: Dict[str, tuple] = {}    # name -> (payload, index)
        self._files: Dict[str, bytes] = {}
        self._nacos: Dict[str, dict] = {}
        self._discovery: Dict[str, dict] = {}
        self._change = threading.Event()
        self._closed = False
        self._fail = 0
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.registry = self
        self.port = self._httpd.server_address[1]
        self.hostport = f"127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fake-registry", daemon=True)
        self._thread.start()

    # ---- content -------------------------------------------------------
    @staticmethod
    def consul_item(host: str, port: int, tags=()) -> dict:
        return {"Node": {"Node": "n-" + host, "Address": host},
                "Service": {"ID": f"{host}:{port}", "Service": "svc",
                            "Tags": list(tags), "Address": host,
                            "Port": port}}

    def set_consul(self, name: str, payload: list,
                   indexed: bool = True) -> Optional[int]:
        """Publish ``payload``; an indexed service moves its index by one
        (releasing the polls held on the old one).  Returns the index."""
        with self.lock:
            old = self._consul.get(name, (None, 0))[1] or 0
            index = old + 1 if indexed else None
            self._consul[name] = (payload, index)
            released, self._change = self._change, threading.Event()
        released.set()
        return index

    def set_file(self, path: str, lines: List[str]) -> None:
        with self.lock:
            self._files[path] = ("\n".join(lines) + "\n").encode()

    def set_nacos(self, name: str, hosts: List[dict]) -> None:
        with self.lock:
            self._nacos[name] = {"name": "DEFAULT_GROUP@@" + name,
                                 "hosts": hosts}

    def set_discovery(self, appid: str, instances: List[dict]) -> None:
        with self.lock:
            self._discovery[appid] = {"code": 0, "data": {
                appid: {"instances": instances}}}

    def fail_next(self, n: int) -> None:
        with self.lock:
            self._fail = n

    def count(self, path: str, since: float = 0.0) -> int:
        with self.lock:
            return sum(1 for t, p, _q in self.queries
                       if p == path and t >= since)

    def close(self) -> None:
        with self.lock:
            self._closed = True
            released = self._change
        released.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5)

    # ---- answers -------------------------------------------------------
    def _answer(self, path: str, query: dict):
        """``(status, headers, body)`` of one GET."""
        with self.lock:
            self.queries.append((time.monotonic(), path, query))
            if self._fail > 0:
                self._fail -= 1
                return 500, {}, b"injected failure"
        if path.startswith(CONSUL_PREFIX):
            return self._answer_consul(path[len(CONSUL_PREFIX):], query)
        with self.lock:
            if path == NACOS_PATH:
                doc = self._nacos.get(query.get("serviceName", ""))
            elif path == DISCOVERY_PATH:
                doc = self._discovery.get(query.get("appid", ""))
            else:
                body = self._files.get(path)
                return (200, {}, body) if body is not None \
                    else (404, {}, b"")
        if doc is None:
            return 404, {}, b""
        return 200, {}, json.dumps(doc).encode()

    def _answer_consul(self, name: str, query: dict):
        deadline = time.monotonic() + self.HOLD_S
        while True:
            with self.lock:
                entry = self._consul.get(name)
                change = self._change
                closed = self._closed
            if entry is None:
                return 404, {}, b""
            payload, index = entry
            if (index is None or closed or query.get("index") != str(index)
                    or time.monotonic() >= deadline):
                break
            # consul holds a poll that presents the current index until
            # the index moves (or the hold ends)
            change.wait(max(0.0, deadline - time.monotonic()))
        headers = {} if index is None else {"X-Consul-Index": str(index)}
        return 200, headers, json.dumps(payload).encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"

    def do_GET(self):
        u = urlparse(self.path)
        query = {k: v[0] for k, v in parse_qs(u.query).items()}
        status, headers, body = self.server.registry._answer(u.path, query)
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            pass                 # the client went (a stopped watch)

    def log_message(self, *args):
        pass
