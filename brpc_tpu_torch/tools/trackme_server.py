"""trackme_server — receives version pings and serves bulletins (port of
:mod:`brpc_tpu.tools.trackme_server`).

Reference: tools/trackme_server/ (a server counting per-version pings and
answering with warnings for known-bad versions).  Run standalone:

    python -m brpc_tpu_torch.tools.trackme_server --port 8877

or embed TrackMeService in any Server.  Bad-version ranges can be added
with add_bulletin(); ping counts are exposed via bvar
(trackme_ping_count) so /vars shows adoption."""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from .. import bvar
from ..butil import logging as log
from ..proto.trackme_pb2 import (TrackMeRequest, TrackMeResponse,
                                 TRACKME_OK, TRACKME_WARNING)
from ..rpc import Service, method

_g_pings = bvar.Adder("trackme_ping_count")


class TrackMeService(Service):
    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._version_counts: Dict[int, int] = {}
        # (min_version, max_version, severity, text)
        self._bulletins: List[Tuple[int, int, int, str]] = []

    def add_bulletin(self, min_version: int, max_version: int,
                     severity: int, text: str) -> None:
        with self._lock:
            self._bulletins.append((min_version, max_version, severity,
                                    text))

    def version_counts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._version_counts)

    @method(TrackMeRequest, TrackMeResponse)
    def TrackMe(self, cntl, request, response, done):
        _g_pings << 1
        with self._lock:
            self._version_counts[request.rpc_version] = \
                self._version_counts.get(request.rpc_version, 0) + 1
            hits = [b for b in self._bulletins
                    if b[0] <= request.rpc_version <= b[1]]
        response.severity = TRACKME_OK
        for _, _, severity, text in hits:
            if severity >= response.severity:
                response.severity = severity
                response.error_text = text
        log.info("trackme ping: version=%d from %s", request.rpc_version,
                 request.server_addr or cntl.remote_side)
        done()


def main() -> None:
    import argparse
    from ..rpc import Server
    parser = argparse.ArgumentParser(description="trackme bulletin server")
    parser.add_argument("--port", type=int, default=8877)
    parser.add_argument("--warn-below", type=int, default=0,
                        help="warn versions below this value")
    args = parser.parse_args()
    svc = TrackMeService()
    if args.warn_below:
        svc.add_bulletin(0, args.warn_below - 1, TRACKME_WARNING,
                         f"please upgrade to >= {args.warn_below}")
    server = Server()
    server.add_service(svc)
    if server.start(f"0.0.0.0:{args.port}") != 0:
        raise SystemExit("failed to start")
    log.info("trackme_server listening on %d", args.port)
    server.join()


if __name__ == "__main__":
    main()
