"""A thrift framed-binary echo (example/thrift_extension_c++: a
ThriftService served beside every other protocol).

    python -m brpc_tpu_torch.examples.thrift_echo            # card
    python -m brpc_tpu_torch.examples.thrift_echo --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import parse_device, setup_mesh
from brpc_tpu_torch.policy.thrift import ThriftMessage, ThriftService, TType

ARG_SPEC = {1: ("name", TType.STRING)}
RESULT_SPEC = {0: ("greeting", TType.STRING)}


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    svc = ThriftService()
    svc.add_method("Greet",
                   lambda args: {"greeting":
                                 b"hello " + args.get("name", b"?")},
                   ARG_SPEC, RESULT_SPEC)
    server = rpc.Server()
    server.add_service(svc)
    ch = rpc.Channel()
    try:
        if server.start("mem://thrift-example") != 0:
            return 1
        ch.init("mem://thrift-example",
                options=rpc.ChannelOptions(protocol="thrift",
                                           timeout_ms=2000))
        cntl = rpc.Controller()
        req = ThriftMessage("Greet", {"name": "fabric"}, ARG_SPEC,
                            RESULT_SPEC)
        resp = ch.call_method("Greet", cntl, req, None)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        print("thrift ->", resp.values["greeting"])
        return 0 if resp.values["greeting"] == b"hello fabric" else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
