"""Echo over the port's native C++ TCP datapath: a NativeServer hosting
both a zero-Python native echo method and a regular Python service, called
through a NativeChannel.  Host only (no tensor crosses), the same on the
card's host and here:

    python -m brpc_tpu_torch.examples.native_echo            # card
    python -m brpc_tpu_torch.examples.native_echo --device cpu
"""
from __future__ import annotations

import statistics
import sys
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import native
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh)
from brpc_tpu_torch.rpc.native_fabric import NativeChannel, NativeServer


class EchoService(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    if not native.available():
        print("native core unavailable; skipping")
        return 0
    server = NativeServer()
    server.add_service(EchoService())               # Python handler tier
    server.register_native_echo("RawEcho.Echo")     # zero-Python tier
    port = server.start()
    ch = NativeChannel()
    ch.init(f"127.0.0.1:{port}")
    try:
        lats = []
        for i in range(50):
            cntl = rpc.Controller()
            t0 = time.perf_counter_ns()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  EchoRequest(message=f"n{i}"), EchoResponse)
            lats.append((time.perf_counter_ns() - t0) / 1000)
            assert not cntl.failed(), cntl.error_text_
            assert resp.message == f"n{i}"
        print(f"python-service over native datapath: p50="
              f"{statistics.median(lats):.1f}us")
        # the all-native tier, measured inside C (no ctypes per call)
        p50 = native.native_rpc_echo_p50_us(iters=1000, payload=4096)
        print(f"full native stack echo (4KB): p50={p50:.1f}us")
        return 0
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
