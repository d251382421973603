"""Cascade echo (example/cascade_echo_c++): a handler that calls a
downstream server itself, its call inside the upstream deadline.  The
front answers ``front:`` + what the back echoed behind its tag.

    python -m brpc_tpu_torch.examples.cascade_echo            # card
    python -m brpc_tpu_torch.examples.cascade_echo --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh,
                                            start_echo_server)


class CascadeService(rpc.Service):
    """Echoes through a downstream echo server, tagging each hop."""

    def __init__(self, downstream_target: str):
        self.channel = rpc.Channel()
        self.channel.init(downstream_target,
                          options=rpc.ChannelOptions(timeout_ms=500))

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        inner_cntl = rpc.Controller()
        inner = self.channel.call_method(
            "EchoService.Echo", inner_cntl,
            EchoRequest(message=request.message), EchoResponse)
        if inner_cntl.failed():
            cntl.set_failed(inner_cntl.error_code, inner_cntl.error_text)
        else:
            response.message = "front:" + inner.message
        done()


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    back = start_echo_server("mem://cascade-back", tag="back")
    cascade = CascadeService("mem://cascade-back")
    front = rpc.Server()
    front.add_service(cascade)
    ch = rpc.Channel()
    try:
        if front.start("mem://cascade-front") != 0:
            return 1
        ch.init("mem://cascade-front",
                options=rpc.ChannelOptions(timeout_ms=1000))
        cntl = rpc.Controller()
        resp = ch.call_method("CascadeService.Echo", cntl,
                              EchoRequest(message="hop"), EchoResponse)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        print(f"cascade -> {resp.message!r} (2 hops, "
              f"latency={cntl.latency_us}us)")
        return 0 if resp.message == "front:back:hop" else 1
    finally:
        ch.close()
        cascade.channel.close()
        front.stop()
        back.stop()


if __name__ == "__main__":
    sys.exit(main())
