"""gRPC echo (example/grpc_c++): a protobuf service served over HTTP/2
with gRPC framing; the same port answers tpu_std, HTTP/1.1 and gRPC.

    python -m brpc_tpu_torch.examples.grpc_echo            # card
    python -m brpc_tpu_torch.examples.grpc_echo --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            EchoService, parse_device,
                                            setup_mesh)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = rpc.Server()
    server.add_service(EchoService(tag="grpc"))
    ch = rpc.Channel()
    try:
        if server.start("127.0.0.1:0") != 0:
            return 1
        ch.init(f"127.0.0.1:{server.listen_port}",
                options=rpc.ChannelOptions(protocol="grpc",
                                           timeout_ms=2000))
        for i in range(3):
            cntl = rpc.Controller()
            resp = ch.call_method("EchoService.Echo", cntl,
                                  EchoRequest(message=f"g{i}"),
                                  EchoResponse)
            if cntl.failed():
                print(f"call failed: {cntl.error_text}")
                return 1
            print(f"grpc echo -> {resp.message!r}")
            if resp.message != f"grpc:g{i}":
                return 1
        return 0
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
