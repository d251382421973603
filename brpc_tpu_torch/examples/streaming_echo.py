"""Streaming RPC with flow control, tensors in the frames
(example/streaming_echo_c++).

A server on ici://1 accepts a stream and echoes every chunk back; the
client, on rank 2, writes 16 DEVICE chunks of 64 KiB owned by its rank.
Each chunk crosses on the device plane both ways (one ``p2p_copy`` each)
and comes back byte for byte.

    python -m brpc_tpu_torch.examples.streaming_echo            # card
    python -m brpc_tpu_torch.examples.streaming_echo --device cpu
"""
from __future__ import annotations

import sys
import threading

import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh)

CHUNKS, CHUNK_BYTES = 16, 64 * 1024


class StreamingService(rpc.Service):
    @rpc.method(EchoRequest, EchoResponse)
    def StartStream(self, cntl, request, response, done):
        class EchoBack(rpc.StreamInputHandler):
            def __init__(self):
                self.stream = None

            def on_received_messages(self, sid, msgs):
                for m in msgs:
                    self.stream.write(m, timeout=10)

        handler = EchoBack()
        handler.stream = rpc.stream_accept(
            cntl, rpc.StreamOptions(handler=handler, max_buf_size=4 << 20))
        response.message = "stream accepted"
        done()


class Collector(rpc.StreamInputHandler):
    def __init__(self, expect: int):
        self.got = []
        self.expect = expect
        self.done = threading.Event()

    def on_received_messages(self, sid, msgs):
        self.got.extend(msgs)
        if len(self.got) >= self.expect:
            self.done.set()


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    mesh = setup_mesh(device)
    from brpc_tpu_torch.ici import device_plane
    server = rpc.Server()
    server.add_service(StreamingService())
    assert server.start("ici://1") == 0
    channel = rpc.Channel()
    try:
        channel.init("ici://1", options=rpc.ChannelOptions(timeout_ms=10000))
        collector = Collector(CHUNKS)
        cntl = rpc.Controller()
        stream = rpc.stream_create(cntl, rpc.StreamOptions(
            handler=collector, max_buf_size=4 << 20))
        channel.call_method("StreamingService.StartStream", cntl,
                            EchoRequest(message="go"), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert stream.wait_connected(5)
        gen = torch.Generator().manual_seed(0)
        sent = [torch.randint(0, 256, (CHUNK_BYTES,), dtype=torch.uint8,
                              generator=gen) for _ in range(CHUNKS)]
        transfers0 = device_plane.plane().stats()["transfers"]
        for chunk in sent:
            buf = IOBuf()
            buf.append_device_array(mesh.device_put(chunk, 2))
            assert stream.write(buf, timeout=10) == 0
        assert collector.done.wait(10), "the echoes never all came back"
        same = all(m.to_bytes() == bytes(c.numpy())
                   for m, c in zip(collector.got, sent))
        transfers = device_plane.plane().stats()["transfers"] - transfers0
        stream.close()
        print(f"{len(collector.got)} chunks of {CHUNK_BYTES} B echoed, "
              f"byte-equal {same}, {transfers} plane transfers")
        return 0 if same and transfers == 2 * CHUNKS else 1
    finally:
        channel.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
