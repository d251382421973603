"""Echo QPS from many threads (example/multi_threaded_echo_c++): the
threads share one channel to a ``mem://`` server for a fixed time.

    python -m brpc_tpu_torch.examples.multi_threaded_echo            # card
    python -m brpc_tpu_torch.examples.multi_threaded_echo --device cpu \\
        --threads 4 --seconds 0.5
"""
from __future__ import annotations

import sys
import threading
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            device_parser, setup_mesh,
                                            start_echo_server)


def main(argv=None) -> int:
    ap = device_parser(__doc__)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    setup_mesh(args.device)
    server = start_echo_server("mem://example-mt-echo")
    channel = rpc.Channel()
    counts = [0] * args.threads
    errors = [0]
    lock = threading.Lock()

    def worker(idx: int) -> None:
        while time.monotonic() < stop_at:
            cntl = rpc.Controller()
            channel.call_method("EchoService.Echo", cntl,
                                EchoRequest(message="m"), EchoResponse)
            if cntl.failed():
                with lock:
                    errors[0] += 1
            else:
                counts[idx] += 1

    try:
        channel.init("mem://example-mt-echo",
                     options=rpc.ChannelOptions(timeout_ms=5000))
        stop_at = time.monotonic() + args.seconds
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(args.threads)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        dt = time.monotonic() - t0
        total = sum(counts)
        print(f"{total} calls in {dt:.2f}s over {args.threads} threads "
              f"-> {total / dt:.0f} qps, {errors[0]} errors")
        return 0 if total > 0 and errors[0] == 0 else 1
    finally:
        channel.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
