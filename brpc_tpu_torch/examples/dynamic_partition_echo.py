"""DynamicPartitionChannel: traffic follows each scheme's capacity
(example/dynamic_partition_echo_c++).

Three echo servers: ici://1 serves a one-partition scheme, ici://2 and
ici://3 a two-partition one.  Calls pick a complete scheme in proportion
to the servers it has.

    python -m brpc_tpu_torch.examples.dynamic_partition_echo            # card
    python -m brpc_tpu_torch.examples.dynamic_partition_echo --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.examples.common import (ConcatMerger, EchoRequest,
                                            EchoResponse, parse_device,
                                            setup_mesh, start_echo_server)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    servers = [start_echo_server(f"ici://{i + 1}", tag=f"n{i}")
               for i in range(3)]
    url = "list://ici://1 100 0/1,ici://2 100 0/2,ici://3 100 1/2"
    dpc = channels.DynamicPartitionChannel()
    try:
        assert dpc.init([1, 2], url, merger=ConcatMerger()) == 0
        scheme_hits = {1: 0, 2: 0}
        for _ in range(20):
            cntl = rpc.Controller()
            resp = EchoResponse()
            dpc.call_method("EchoService.Echo", cntl,
                            EchoRequest(message="d"), resp)
            assert not cntl.failed(), cntl.error_text
            scheme_hits[len(resp.message.split("|"))] += 1
        print(f"calls served by the 1-partition scheme: {scheme_hits[1]}, "
              f"the 2-partition scheme: {scheme_hits[2]}")
        return 0
    finally:
        dpc.close()
        for s in servers:
            s.stop()


if __name__ == "__main__":
    sys.exit(main())
