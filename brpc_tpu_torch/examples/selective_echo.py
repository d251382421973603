"""SelectiveChannel: balancing between channels with retry on another
(example/selective_echo_c++).

Two sub-channels: one to an endpoint nobody listens on, one to a live
echo server on ici://1.  Every call lands, the ones that picked the dead
channel first after one retry.

    python -m brpc_tpu_torch.examples.selective_echo            # card
    python -m brpc_tpu_torch.examples.selective_echo --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh,
                                            start_echo_server)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    live = start_echo_server("ici://1", tag="live")
    dead, ok = rpc.Channel(), rpc.Channel()
    try:
        schan = channels.SelectiveChannel()
        dead.init("ici://7", options=rpc.ChannelOptions(timeout_ms=200,
                                                        max_retry=0))
        ok.init("ici://1", options=rpc.ChannelOptions(timeout_ms=10000))
        schan.add_channel(dead)
        schan.add_channel(ok)
        failures = 0
        for i in range(4):
            cntl = rpc.Controller()
            resp = schan.call_method("EchoService.Echo", cntl,
                                     EchoRequest(message=f"sel-{i}"),
                                     EchoResponse)
            failures += cntl.failed()
            print(f"selected -> {resp.message if resp else cntl.error_text}"
                  f" (retried={cntl.retried_count})")
        return 1 if failures else 0
    finally:
        ok.close()
        live.stop()


if __name__ == "__main__":
    sys.exit(main())
