"""An nshead protocol extension (example/nshead_extension_c++): a
home-grown nshead-framed protocol served by subclassing NsheadService.
Its payload is raw bytes, answered reversed.

    python -m brpc_tpu_torch.examples.nshead_extension            # card
    python -m brpc_tpu_torch.examples.nshead_extension --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import parse_device, setup_mesh
from brpc_tpu_torch.policy.nshead import NsheadMessage, NsheadService


class ReverseService(NsheadService):
    def process_nshead_request(self, server, cntl, request, response,
                               done):
        response.body.append(request.body.to_bytes()[::-1])
        done()


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = rpc.Server()
    server.add_service(ReverseService())
    ch = rpc.Channel()
    try:
        if server.start("mem://nshead-example") != 0:
            return 1
        ch.init("mem://nshead-example",
                options=rpc.ChannelOptions(protocol="nshead",
                                           timeout_ms=2000))
        req = NsheadMessage()
        req.head.log_id = 7
        req.body.append(b"stressed")
        cntl = rpc.Controller()
        resp = ch.call_method("", cntl, req)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        print("nshead ->", resp.body.to_bytes())
        return 0 if resp.body.to_bytes() == b"desserts" else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
