"""Async completion and pooled connections on the port's native TCP
datapath (example/asynchronous_echo_c++, socket.h:256-262):
``call_method_async`` returns a future whose done-callback fires from the
channel's reader thread; ``NativePooledChannel`` round-robins N
connections so concurrent large calls overlap in the kernel.  Host only:

    python -m brpc_tpu_torch.examples.native_async_pool            # card
    python -m brpc_tpu_torch.examples.native_async_pool --device cpu
"""
from __future__ import annotations

import sys
import threading

from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import native
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh)
from brpc_tpu_torch.rpc.native_fabric import (NativeChannel, NativePooledChannel,
                                        NativeServer)


class EchoService(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message[::-1]
        done()


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    if not native.available():
        print("native core unavailable; skipping")
        return 0
    server = NativeServer()
    server.add_service(EchoService())
    port = server.start()

    # ---- async: fire 8 overlapping calls, completions via callbacks ----
    ch = NativeChannel()
    ch.init(f"127.0.0.1:{port}")
    done_count = [0]
    all_done = threading.Event()

    def on_done(cntl):
        done_count[0] += 1
        if done_count[0] == 8:
            all_done.set()

    futs = []
    for i in range(8):
        cntl = rpc.Controller()
        cntl.timeout_ms = 5000
        futs.append(ch.call_method_async(
            "EchoService.Echo", cntl, EchoRequest(message=f"async-{i}"),
            EchoResponse, done=on_done))
    assert all_done.wait(10)
    for i, fut in enumerate(futs):
        assert fut.wait(1) and not fut.cntl.failed()
        assert fut.response.message == f"async-{i}"[::-1]
    ch.close()
    print(f"async: {len(futs)} overlapping calls completed via callbacks")

    # ---- pooled: concurrent callers over 3 connections -----------------
    pool = NativePooledChannel()
    pool.init(f"127.0.0.1:{port}", nconns=3)
    errs = []

    def worker(wid):
        try:
            for i in range(10):
                cntl = rpc.Controller()
                cntl.timeout_ms = 5000
                resp = pool.call_method(
                    "EchoService.Echo", cntl,
                    EchoRequest(message=f"p{wid}-{i}"), EchoResponse)
                assert not cntl.failed() and \
                    resp.message == f"p{wid}-{i}"[::-1]
        except Exception as e:           # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    pool.close()
    server.stop()
    print("pooled: 4 threads x 10 calls over 3 connections, all verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
