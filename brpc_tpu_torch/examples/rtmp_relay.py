"""An RTMP publish-to-play relay (the reference's rtmp.h live-streaming
API): one client publishes, the server relays each video frame to the
players of the stream's name.

    python -m brpc_tpu_torch.examples.rtmp_relay            # card
    python -m brpc_tpu_torch.examples.rtmp_relay --device cpu
"""
from __future__ import annotations

import sys
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import parse_device, setup_mesh
from brpc_tpu_torch.policy.rtmp import (RtmpClient, RtmpClientStream,
                                        RtmpServerStream, RtmpService)

FRAMES = 10


class RelayService(RtmpService):
    def __init__(self):
        self.players = {}

    def new_stream(self, remote_side, connect_info):
        relay = self

        class Stream(RtmpServerStream):
            def on_play(s, name):
                relay.players.setdefault(name, []).append(s)
                return 0

            def on_video_message(s, timestamp, data):
                for p in relay.players.get(s.publish_name, []):
                    p.send_video_message(data, timestamp)
        return Stream()


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = rpc.Server()
    server.add_service(RelayService())
    clients = []
    try:
        if server.start("127.0.0.1:0") != 0:
            return 1
        target = f"127.0.0.1:{server.listen_port}"
        publisher = RtmpClient(target)
        clients.append(publisher)
        pub = publisher.create_stream()
        if pub.publish("cam0") != 0:
            return 1
        frames = []

        class Player(RtmpClientStream):
            def on_video_message(self, timestamp, data):
                frames.append((timestamp, len(data)))

        viewer = RtmpClient(target)
        clients.append(viewer)
        if viewer.create_stream(Player()).play("cam0") != 0:
            return 1
        for i in range(FRAMES):
            pub.send_video_message(b"\x17\x01" + bytes(4096), i * 40)
        deadline = time.monotonic() + 5
        while len(frames) < FRAMES and time.monotonic() < deadline:
            time.sleep(0.02)
        if len(frames) != FRAMES:
            print(f"relayed {len(frames)} of {FRAMES} frames")
            return 1
        print(f"relayed {len(frames)} video frames, ts 0..{frames[-1][0]}")
        return 0 if frames == [(i * 40, 4098) for i in range(FRAMES)] \
            else 1
    finally:
        for c in clients:
            c.stop()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
