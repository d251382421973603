"""Backup (hedged) requests (example/backup_request_c++,
docs/cn/backup_request.md): a second try leaves after
``backup_request_ms``; the first answer wins and the late one is dropped.

A server on ici://1 stalls its first try; the client, on rank 2, sends a
64 KiB DEVICE attachment.  Both tries carry it on the device plane, the
backup's answer comes back byte for byte before the stalled try ends.

    python -m brpc_tpu_torch.examples.backup_request            # card
    python -m brpc_tpu_torch.examples.backup_request --device cpu
"""
from __future__ import annotations

import sys
import time

import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh)

STALL_S, BACKUP_MS = 0.3, 50


class SlowThenFastService(rpc.Service):
    SERVICE_NAME = "EchoService"

    def __init__(self):
        self.calls = 0

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        self.calls += 1
        if self.calls == 1:
            time.sleep(STALL_S)          # the first try is slow
        response.message = f"reply-to-try-{self.calls}"
        cntl.response_attachment.append(cntl.request_attachment)
        done()


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    mesh = setup_mesh(device)
    from brpc_tpu_torch.ici import device_plane
    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True))
    svc = SlowThenFastService()
    server.add_service(svc)
    assert server.start("ici://1") == 0
    ch = rpc.Channel()
    try:
        ch.init("ici://1", options=rpc.ChannelOptions(
            timeout_ms=2000, max_retry=2, backup_request_ms=BACKUP_MS))
        data = torch.randint(0, 256, (64 * 1024,), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(1))
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(mesh.device_put(data, 2))
        transfers0 = device_plane.plane().stats()["transfers"]
        t0 = time.monotonic()
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message="h"), EchoResponse)
        ms = (time.monotonic() - t0) * 1000
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        same = cntl.response_attachment.to_bytes() == bytes(data.numpy())
        time.sleep(STALL_S)              # the stalled try answers, dropped
        transfers = device_plane.plane().stats()["transfers"] - transfers0
        print(f"got {resp.message!r} in {ms:.0f} ms after "
              f"{cntl.retried_count + 1} tries (server saw {svc.calls}); "
              f"attachment byte-equal {same}; {transfers} plane transfers")
        ok = (same and ms < STALL_S * 1000 and svc.calls == 2
              and transfers == 4)
        return 0 if ok else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
