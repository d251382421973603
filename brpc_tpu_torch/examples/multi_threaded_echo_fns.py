"""Echo from scheduler tasklets (example/multi_threaded_echo_fns_c++,
whose callers are bthreads from bthread_start_background): 16 tasklets
make 5 calls each over ``mem://`` and count down one CountdownEvent.

    python -m brpc_tpu_torch.examples.multi_threaded_echo_fns         # card
    python -m brpc_tpu_torch.examples.multi_threaded_echo_fns --device cpu
"""
from __future__ import annotations

import sys
import threading

from brpc_tpu_torch import rpc
from brpc_tpu_torch.bthread import scheduler
from brpc_tpu_torch.bthread.countdown import CountdownEvent
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh,
                                            start_echo_server)

TASKLETS, CALLS_PER_TASKLET = 16, 5


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = start_echo_server("mem://echo-fns")
    channel = rpc.Channel()
    done = CountdownEvent(TASKLETS)
    ok = [0]
    lock = threading.Lock()

    def worker(wid: int) -> None:
        try:
            for i in range(CALLS_PER_TASKLET):
                cntl = rpc.Controller()
                resp = channel.call_method(
                    "EchoService.Echo", cntl,
                    EchoRequest(message=f"w{wid}-{i}"), EchoResponse)
                if cntl.failed() or resp.message != f"w{wid}-{i}":
                    return
                with lock:
                    ok[0] += 1
        finally:
            done.signal()

    try:
        channel.init("mem://echo-fns",
                     options=rpc.ChannelOptions(timeout_ms=2000))
        for wid in range(TASKLETS):
            scheduler.start_background(worker, wid, name=f"echo-fn-{wid}")
        if done.wait(30) != 0:
            print("tasklets did not finish")
            return 1
        print(f"{ok[0]} echoes from {TASKLETS} tasklets OK")
        return 0 if ok[0] == TASKLETS * CALLS_PER_TASKLET else 1
    finally:
        channel.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
