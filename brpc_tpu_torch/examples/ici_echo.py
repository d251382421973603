"""Echo over the ``ici://`` device fabric with a payload on the device
(the counterpart of example/rdma_performance's latency mode): 30 calls to
``ici://0``, each carrying a 65,536-byte ``uint8`` tensor owned by rank 1
that the server returns.  Both legs cross the device plane on
``p2p_copy``; the echoed bytes are checked, and on the card its launches
rise by the plane's transfers.

    python -m brpc_tpu_torch.examples.ici_echo            # card
    python -m brpc_tpu_torch.examples.ici_echo --device cpu
"""
from __future__ import annotations

import sys
import time

import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh,
                                            start_echo_server)

CALLS, NBYTES = 30, 65536


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    mesh = setup_mesh(device)
    from brpc_tpu_torch.ici import device_plane
    from brpc_tpu_torch.ici.p2p_copy import p2p_copy
    from brpc_tpu_torch.ici.transport import ici_transport_stats
    server = start_echo_server("ici://0")
    ch = rpc.Channel()
    try:
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=10000))
        data = (torch.arange(NBYTES) % 256).to(torch.uint8)
        payload = mesh.device_put(data, min(1, mesh.size - 1))
        want = bytes(data.numpy())
        transfers0 = device_plane.plane().stats()["transfers"]
        launches0 = p2p_copy.launches
        lats = []
        for _ in range(CALLS):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            t0 = time.perf_counter_ns()
            ch.call_method("EchoService.Echo", cntl,
                           EchoRequest(message="device"), EchoResponse)
            lats.append((time.perf_counter_ns() - t0) / 1000)
            if cntl.failed():
                print(f"call failed: {cntl.error_text}")
                return 1
            if cntl.response_attachment.to_bytes() != want:
                print("the echoed bytes differ")
                return 1
        transfers = device_plane.plane().stats()["transfers"] - transfers0
        launches = p2p_copy.launches - launches0
        lats.sort()
        _total, device_bytes = ici_transport_stats()
        print(f"ici echo with 64KB {device} payload: "
              f"p50={lats[len(lats) // 2]:.0f}us p99={lats[-1]:.0f}us; "
              f"{transfers} plane transfers, {launches} p2p_copy launches; "
              f"fabric moved {device_bytes} device bytes without host "
              f"copies")
        # on the CPU the plane copies with p2p_copy's plain version, which
        # launches nothing
        want_launches = transfers if device == "cuda" else 0
        return 0 if transfers == 2 * CALLS and launches == want_launches \
            else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
