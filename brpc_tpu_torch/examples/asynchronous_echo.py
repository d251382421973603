"""Async echo with completion callbacks (example/asynchronous_echo_c++):
five calls issued at once over ``mem://``, each answered in its ``done``.

    python -m brpc_tpu_torch.examples.asynchronous_echo            # card
    python -m brpc_tpu_torch.examples.asynchronous_echo --device cpu
"""
from __future__ import annotations

import sys
import threading

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh,
                                            start_echo_server)

CALLS = 5


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = start_echo_server("mem://example-async")
    channel = rpc.Channel()
    done = threading.Event()
    lock = threading.Lock()
    got = []

    def on_done(cntl: rpc.Controller) -> None:
        if cntl.failed():
            print("failed:", cntl.error_text)
        else:
            print("async response:", cntl.response.message)
        with lock:
            got.append(None if cntl.failed() else cntl.response.message)
            if len(got) == CALLS:
                done.set()

    try:
        channel.init("mem://example-async")
        for i in range(CALLS):
            channel.call_method("EchoService.Echo", rpc.Controller(),
                                EchoRequest(message=f"async-{i}"),
                                EchoResponse, on_done)
        if not done.wait(10):
            print("the callbacks did not all run")
            return 1
        return 0 if sorted(got) == [f"async-{i}" for i in range(CALLS)] \
            else 1
    finally:
        channel.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
