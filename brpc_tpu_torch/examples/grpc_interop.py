"""gRPC interop with a foreign implementation: one port serves this
framework's tpu_std clients and an unmodified grpcio client at once, and
``rpc.Channel(protocol="grpc")`` calls an unmodified ``grpc.server()``, so
a fleet can move off stock gRPC one process at a time, either way.  The
wire path is ``/EchoService/Echo``, as the JAX package's example has it,
so grpcio's client reaches either package's server.  Without grpcio it
says so and returns 0.

    python -m brpc_tpu_torch.examples.grpc_interop            # card
    python -m brpc_tpu_torch.examples.grpc_interop --device cpu
"""
from __future__ import annotations

import sys
from concurrent import futures

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            EchoService, parse_device,
                                            setup_mesh)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    try:
        import grpc
    except ImportError:
        print("grpc interop: grpcio not installed, skipping")
        return 0

    # direction 1: a stock grpcio client calls our server
    server = rpc.Server()
    server.add_service(EchoService(tag="ours"))
    own = rpc.Channel()
    try:
        if server.start("127.0.0.1:0") != 0:
            return 1
        gch = grpc.insecure_channel(f"127.0.0.1:{server.listen_port}")
        try:
            stub = gch.unary_unary(
                "/EchoService/Echo",
                request_serializer=EchoRequest.SerializeToString,
                response_deserializer=EchoResponse.FromString)
            resp = stub(EchoRequest(message="hello"), timeout=10)
        finally:
            gch.close()
        print(f"grpcio client -> our server: {resp.message!r}")
        if resp.message != "ours:hello":
            return 1
        # the same port still answers our own protocol's clients
        own.init(f"127.0.0.1:{server.listen_port}",
                 options=rpc.ChannelOptions(timeout_ms=2000))
        cntl = rpc.Controller()
        resp = own.call_method("EchoService.Echo", cntl,
                               EchoRequest(message="native"), EchoResponse)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        print(f"tpu_std client -> same port:  {resp.message!r}")
        if resp.message != "ours:native":
            return 1
    finally:
        own.close()
        server.stop()

    # direction 2: our channel calls a stock grpc.server()
    class Handler(grpc.GenericRpcHandler):
        def service(self, hcd):
            if hcd.method != "/EchoService/Echo":
                return None

            def unary(req, ctx):
                return EchoResponse(message="grpcio:" + req.message)
            return grpc.unary_unary_rpc_method_handler(
                unary, request_deserializer=EchoRequest.FromString,
                response_serializer=EchoResponse.SerializeToString)

    gs = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    gs.add_generic_rpc_handlers((Handler(),))
    port = gs.add_insecure_port("127.0.0.1:0")
    gs.start()
    ch = rpc.Channel()
    try:
        ch.init(f"tcp://127.0.0.1:{port}",
                options=rpc.ChannelOptions(protocol="grpc",
                                           timeout_ms=5000))
        cntl = rpc.Controller()
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message="out"), EchoResponse)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        print(f"our channel  -> grpc.server: {resp.message!r}")
        return 0 if resp.message == "grpcio:out" else 1
    finally:
        ch.close()
        gs.stop(None)


if __name__ == "__main__":
    sys.exit(main())
