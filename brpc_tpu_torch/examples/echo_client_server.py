"""Sync unary echo (example/echo_c++): a client and a server in one
process over ``mem://``, three calls, each carrying a host attachment the
server returns.

    python -m brpc_tpu_torch.examples.echo_client_server            # card
    python -m brpc_tpu_torch.examples.echo_client_server --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh,
                                            start_echo_server)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = start_echo_server("mem://example-echo")
    channel = rpc.Channel()
    try:
        channel.init("mem://example-echo",
                     options=rpc.ChannelOptions(timeout_ms=1000, max_retry=3))
        for i in range(3):
            cntl = rpc.Controller()
            cntl.request_attachment.append(b"attached-bytes")
            response = channel.call_method(
                "EchoService.Echo", cntl,
                EchoRequest(message=f"hello-{i}"), EchoResponse)
            if cntl.failed():
                print(f"call failed: {cntl.error_text}")
                return 1
            att = cntl.response_attachment.to_bytes()
            print(f"echo -> {response.message!r} "
                  f"(latency={cntl.latency_us}us, attachment={att!r})")
            if response.message != f"hello-{i}" or att != b"attached-bytes":
                return 1
        return 0
    finally:
        channel.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
