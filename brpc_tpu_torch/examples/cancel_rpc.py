"""Timeouts and cancellation (example/cancel_c++): a call that outlives
its deadline ends ERPCTIMEDOUT, a call cancelled in flight ends
ECANCELED, and in both cases the server's late answer is dropped by the
versioned correlation id.

The server on ici://1 sleeps 400 ms a call; the cancelled call carries a
64 KiB DEVICE attachment from rank 2, which has crossed on the device
plane when the cancel comes.

    python -m brpc_tpu_torch.examples.cancel_rpc            # card
    python -m brpc_tpu_torch.examples.cancel_rpc --device cpu
"""
from __future__ import annotations

import sys
import threading
import time

import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            EchoService, parse_device,
                                            setup_mesh)
from brpc_tpu_torch.rpc import errors

SLEEP_US = 400_000


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    mesh = setup_mesh(device)
    # the Python plane: a cancel reaches a call there (and on the mem://
    # loopback plane); a call on the native plane runs to its end in C
    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          native_ici=False))
    server.add_service(EchoService())
    assert server.start("ici://1") == 0
    ch = rpc.Channel()
    try:
        ch.init("ici://1", options=rpc.ChannelOptions(timeout_ms=50,
                                                      max_retry=0))
        cntl = rpc.Controller()
        t0 = time.monotonic()
        ch.call_method("EchoService.Echo", cntl,
                       EchoRequest(message="slow", sleep_us=SLEEP_US),
                       EchoResponse)
        timed_out = cntl.error_code == errors.ERPCTIMEDOUT
        print(f"call timed out after {(time.monotonic() - t0) * 1000:.0f} "
              f"ms as configured ({cntl.error_text})")

        cntl = rpc.Controller()
        cntl.timeout_ms = 5000
        cntl.request_attachment.append_device_array(mesh.device_put(
            torch.arange(64 * 1024).to(torch.uint8), 2))
        ended = threading.Event()
        ch.call_method("EchoService.Echo", cntl,
                       EchoRequest(message="slow", sleep_us=SLEEP_US),
                       EchoResponse, lambda c: ended.set())
        time.sleep(0.05)
        t0 = time.monotonic()
        cntl.cancel()
        ended.wait(5)
        cancelled = cntl.error_code == errors.ECANCELED
        print(f"cancelled call ended {cntl.error_text!r} "
              f"{(time.monotonic() - t0) * 1e6:.0f} us after cancel()")
        time.sleep(SLEEP_US / 1e6)      # both late answers are dropped
        dropped = (cntl.error_code == errors.ECANCELED
                   and cntl.response is None)
        print(f"late answers dropped: {dropped}")
        return 0 if timed_out and cancelled and dropped else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
