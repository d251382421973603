"""PartitionChannel over tagged naming (example/partition_echo_c++).

Three echo servers on ici://1-3 announce partitions 0/3, 1/3 and 2/3 in
a ``list://`` url; a PartitionChannel fans every call out across the
three partitions.

    python -m brpc_tpu_torch.examples.partition_echo            # card
    python -m brpc_tpu_torch.examples.partition_echo --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.examples.common import (ConcatMerger, EchoRequest,
                                            EchoResponse, parse_device,
                                            setup_mesh, start_echo_server)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    servers = [start_echo_server(f"ici://{i + 1}", tag=f"part{i}")
               for i in range(3)]
    url = "list://" + ",".join(f"ici://{i + 1} 100 {i}/3" for i in range(3))
    pc = channels.PartitionChannel()
    try:
        assert pc.init(3, url, merger=ConcatMerger()) == 0
        assert pc.partitions_ready()
        cntl = rpc.Controller()
        resp = EchoResponse()
        pc.call_method("EchoService.Echo", cntl,
                       EchoRequest(message="pt"), resp)
        assert not cntl.failed(), cntl.error_text
        parts = sorted(resp.message.split("|"))
        print("partition responses:", parts)
        return 0 if parts == [f"part{i}:pt" for i in range(3)] else 1
    finally:
        pc.close()
        for s in servers:
            s.stop()


if __name__ == "__main__":
    sys.exit(main())
