"""ParallelChannel fan-out (example/parallel_echo_c++), with a tensor
sharded across the sub-calls.

Four echo servers on ici://1-4; a ParallelChannel over them first
replicates a message, then a CallMapper sends each server one shard of a
float32 tensor as a DEVICE attachment and a merger puts the echoed shards
back in order.  Every shard crosses on the device plane out and back.

    python -m brpc_tpu_torch.examples.parallel_echo            # card
    python -m brpc_tpu_torch.examples.parallel_echo --device cpu
"""
from __future__ import annotations

import sys

import torch

from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.examples.common import (ConcatMerger, EchoRequest,
                                            EchoResponse, parse_device,
                                            setup_mesh, start_echo_server)

MEMBERS = 4


class ShardMapper(channels.CallMapper):
    """Sub-call i carries row i of the (MEMBERS, n) tensor."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    def map(self, i, method, request):
        att = IOBuf()
        att.append_device_array(self.rows[i].contiguous().view(torch.uint8))
        return channels.SubCall(request, attachment=att)


class ShardMerger(channels.ResponseMerger):
    """Keeps each sub-call's echoed shard by its index."""

    def __init__(self, out: dict):
        self.out = out

    def merge_sub(self, parent_cntl, index, sub_cntl, response):
        ref = sub_cntl.response_attachment.backing_block(0)
        self.out[index] = ref.block.data[ref.offset:ref.offset + ref.length]
        return self.MERGED


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    mesh = setup_mesh(device)
    servers = [start_echo_server(f"ici://{i + 1}", tag=f"s{i + 1}")
               for i in range(MEMBERS)]
    subs = []
    try:
        pchan = channels.ParallelChannel(fail_limit=2)
        for i in range(MEMBERS):
            ch = rpc.Channel()
            ch.init(f"ici://{i + 1}",
                    options=rpc.ChannelOptions(timeout_ms=10000))
            subs.append(ch)
            pchan.add_channel(ch, merger=ConcatMerger())
        cntl = rpc.Controller()
        resp = EchoResponse()
        pchan.call_method("EchoService.Echo", cntl,
                          EchoRequest(message="fanout"), resp)
        assert not cntl.failed(), cntl.error_text
        print("replicated fan-out merged:", sorted(resp.message.split("|")))

        x = torch.arange(MEMBERS * 1024, dtype=torch.float32).reshape(
            MEMBERS, 1024)
        rows = mesh.device_put(x, 0)
        shards = {}
        tensor_chan = channels.ParallelChannel()
        merger = ShardMerger(shards)
        for ch in subs:
            tensor_chan.add_channel(ch, mapper=ShardMapper(rows),
                                    merger=merger)
        cntl = rpc.Controller()
        tensor_chan.call_method("EchoService.Echo", cntl,
                                EchoRequest(message="shard"), EchoResponse())
        assert not cntl.failed(), cntl.error_text
        back = torch.stack([shards[i].view(torch.float32)
                            for i in range(MEMBERS)]).cpu()
        same = torch.equal(back, x)
        print(f"sharded fan-out of {tuple(x.shape)} float32: merged equal "
              f"{same}")
        return 0 if same else 1
    finally:
        for ch in subs:
            ch.close()
        for s in servers:
            s.stop()


if __name__ == "__main__":
    sys.exit(main())
