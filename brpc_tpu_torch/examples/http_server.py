"""HTTP/JSON access and the builtin admin pages (example/http_c++): the
echo on a TCP port called with a JSON body over HTTP/1.1, then the
health, status, vars and metrics pages.

    python -m brpc_tpu_torch.examples.http_server            # card
    python -m brpc_tpu_torch.examples.http_server --device cpu
"""
from __future__ import annotations

import json
import sys
import urllib.request

from brpc_tpu_torch.examples.common import (parse_device, setup_mesh,
                                            start_echo_server)

PAGES = ("health", "status", "vars?filter=rpc_*", "brpc_metrics")


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = start_echo_server("127.0.0.1:0")
    try:
        base = f"http://127.0.0.1:{server.listen_port}"
        req = urllib.request.Request(
            f"{base}/EchoService/Echo",
            data=json.dumps({"message": "over-http"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as r:
            answer = json.loads(r.read())
        print("JSON RPC:", answer)
        for page in PAGES:
            with urllib.request.urlopen(f"{base}/{page}", timeout=5) as r:
                body = r.read().decode()
                if r.status != 200:
                    return 1
            print(f"/{page}: {body[:80].strip()!r}...")
        return 0 if answer == {"message": "over-http"} else 1
    finally:
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
