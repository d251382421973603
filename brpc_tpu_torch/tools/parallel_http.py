"""parallel_http: fetch many URLs at once and report success and latency.

Reference: tools/parallel_http, ported from
:mod:`brpc_tpu.tools.parallel_http`.  Operators use it to probe a fleet's
admin pages::

    python -m brpc_tpu_torch.tools.parallel_http --urls urls.txt \\
        --concurrency 32

``fetch_all`` prints one JSON summary line (``urls``, ``ok``, ``failed``,
``elapsed_s``, ``avg_latency_ms``) and returns it with every fetch's
``(index, url, status, bytes, seconds, error)`` in index order.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request
from typing import List


def fetch_all(urls: List[str], concurrency: int = 16,
              timeout: float = 5.0, out=sys.stderr) -> dict:
    results = []
    lock = threading.Lock()
    queue = list(enumerate(urls))

    def worker():
        while True:
            with lock:
                if not queue:
                    return
                idx, url = queue.pop()
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=timeout) as r:
                    body = r.read()
                    rec = (idx, url, r.status, len(body),
                           time.perf_counter() - t0, "")
            except Exception as e:      # a failed fetch is a result row
                rec = (idx, url, 0, 0, time.perf_counter() - t0, str(e))
            with lock:
                results.append(rec)

    threads = [threading.Thread(target=worker)
               for _ in range(min(concurrency, max(len(urls), 1)))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    ok = sum(1 for r in results if 200 <= r[2] < 300)
    summary = {
        "urls": len(urls), "ok": ok, "failed": len(urls) - ok,
        "elapsed_s": round(elapsed, 2),
        "avg_latency_ms": round(
            sum(r[4] for r in results) / max(len(results), 1) * 1000, 1),
    }
    print(json.dumps(summary), file=out)
    return {"summary": summary, "results": sorted(results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--urls", required=True,
                    help="file with one URL per line, or comma-joined list")
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)
    if "," in args.urls or args.urls.startswith("http"):
        urls = [u for u in args.urls.split(",") if u]
    else:
        with open(args.urls) as f:
            urls = [line.strip() for line in f if line.strip()]
    fetch_all(urls, args.concurrency, args.timeout, out=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
