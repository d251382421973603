"""rpc_view: render another server's builtin pages from the command line.

Reference: tools/rpc_view, ported from :mod:`brpc_tpu.tools.rpc_view`.  It
fetches and prints a server's admin pages over whatever transport the
server listens on: HTTP for a TCP address, and the HTTP protocol over the
fabric socket for ``mem://`` and ``ici://``.  A naming url (``pod://``,
``mesh://``, ``list://``, ...) or a comma-separated list renders each
resolved member's page in a section of its own.  An empty resolution is a
hard error, so a mistyped pod name never shows nothing::

    python -m brpc_tpu_torch.tools.rpc_view --server 127.0.0.1:8000 \\
        --page status
    python -m brpc_tpu_torch.tools.rpc_view --server pod://default \\
        --page rpcz --query trace_id=abcd
"""
from __future__ import annotations

import argparse
import sys
import threading
import urllib.request
from typing import List, Tuple


def resolve_servers(server: str) -> List[str]:
    """One target per resolved member (``policy.naming.resolve_servers``);
    ValueError on an empty resolution."""
    import brpc_tpu_torch.policy  # noqa: F401  (registers the schemes)
    from brpc_tpu_torch.policy.naming import resolve_servers as _resolve
    return _resolve(server)


def fetch_page(server: str, page: str, query: str = "") -> str:
    path = f"/{page}{'?' + query if query else ''}"
    if not server.startswith(("mem://", "ici://")):
        with urllib.request.urlopen(f"http://{server}{path}",
                                    timeout=5) as r:
            return r.read().decode("utf-8", "replace")
    # an in-process target: the HTTP protocol over the fabric socket
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch.butil.endpoint import parse_endpoint
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.policy import http as http_proto
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.input_messenger import InputMessenger
    from brpc_tpu_torch.rpc.socket_map import SocketMap

    got = {}
    evt = threading.Event()

    def process_response(msg, socket):
        got["msg"] = msg
        evt.set()

    proto = http_proto.Protocol(name="http_view", parse=http_proto.parse,
                                process_response=process_response)
    sock = SocketMap.instance().get_short_socket(
        parse_endpoint(server), InputMessenger(protocols=[proto]))
    try:
        sock.write(IOBuf(f"GET {path} HTTP/1.1\r\nHost: {server}\r\n\r\n"
                         .encode()))
        if not evt.wait(5):
            raise TimeoutError("no response")
    finally:
        sock.set_failed(errors.ECLOSE, "view done")
    return got["msg"].body.decode("utf-8", "replace")


def fetch_pages(server: str, page: str,
                query: str = "") -> List[Tuple[str, str]]:
    """(target, body) for every member ``server`` resolves to, fetched
    at once: a pod keeps a crashed member's record up, so the members'
    timeouts must overlap.  A member that does not answer gives its error
    text as its body, so one dead member never hides the rest."""
    targets = resolve_servers(server)
    bodies: List[str] = [""] * len(targets)

    def fetch(i, target):
        try:
            bodies[i] = fetch_page(target, page, query)
        except Exception as e:          # the member's row shows the error
            bodies[i] = f"<error: {type(e).__name__}: {e}>\n"

    threads = [threading.Thread(target=fetch, args=(i, t), daemon=True)
               for i, t in enumerate(targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return list(zip(targets, bodies))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--server", required=True,
                    help="endpoint, comma-separated list, or naming url "
                         "(pod://, mesh://, list://, file://, ...)")
    ap.add_argument("--page", default="status")
    ap.add_argument("--query", default="")
    args = ap.parse_args(argv)
    try:
        pages = fetch_pages(args.server, args.page, args.query)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if len(pages) == 1:
        print(pages[0][1])
        return 0
    for target, body in pages:
        print(f"=== {target} ===")
        print(body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
