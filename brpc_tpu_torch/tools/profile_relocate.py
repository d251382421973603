"""Where a 4 KiB echo's time goes on the native ici:// door, on one card.

    python3 -m brpc_tpu_torch.tools.profile_relocate [--calls N]

Drives phase 3's Sink echo of ``chip_smoke.py`` (IciMesh(ranks=8) on the
card, server on ici://0 answering inline, 4 KiB attachment) in five shapes,
each after 30 warm-up calls: on the native door with the attachment owned
by rank 1 and relocated on the device plane (threshold 1), relocated with
``mesh.device_put`` (threshold above the payload), and owned by rank 0
already (no relocation); on the Python plane with rank 1's attachment and
with rank 0's.  For the first it times the relocation upcall and its parts
(``DevicePlane.post_send``, ``post_recv`` with its ``_run`` and
``_matched``, ``order_after_copies``) with the host clock, and it times a
bare ``post_send`` + ``post_recv`` with no RPC around it.  Prints the
card's ``nvidia-smi`` name and power limit, then one JSON object of p50s
and mean µs per part.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import torch

SIZE = 4096
PARTS = ("post_send", "post_recv", "_run", "_matched",
         "order_after_copies")


def _timed(owner, name, acc):
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return real(*args, **kwargs)
        finally:
            acc[name].append(time.perf_counter_ns() - t0)

    setattr(owner, name, wrapper)


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else -1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_relocate: needs a CUDA device", file=sys.stderr)
        return 1
    from .. import policy  # noqa: F401  (registers tpu_std)
    from .. import rpc
    from ..butil import flags
    from ..ici import device_plane, native_plane
    from ..ici.mesh import IciMesh
    from ..proto.echo_pb2 import EchoRequest, EchoResponse
    from .timing import nvidia_smi_line

    print(nvidia_smi_line(), flush=True)
    acc = collections.defaultdict(list)
    for name in PARTS:
        _timed(device_plane.DevicePlane, name, acc)
    # before the first binding installs the upcall
    _timed(native_plane, "_relocate", acc)

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            response.message = str(len(cntl.request_attachment))
            done()

    mesh = IciMesh(ranks=8)
    IciMesh.set_default(mesh)
    data = torch.arange(SIZE).to(torch.uint8)

    def shape(native, threshold, owner):
        flags.set_flag("ici_device_plane_threshold", threshold)
        server = rpc.Server(rpc.ServerOptions(usercode_inline=True,
                                              native_ici=native))
        server.add_service(Sink())
        if server.start("ici://0") != 0:
            raise RuntimeError("server start on ici://0 failed")
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000,
                                                      max_retry=0))
        payload = mesh.device_put(data.to(mesh.device(owner)), owner)
        torch.cuda.synchronize()

        def one():
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("Sink.Push", cntl,
                                  EchoRequest(message="d"), EchoResponse)
            if cntl.failed() or resp.message != str(SIZE):
                raise RuntimeError(f"Sink.Push failed: {cntl.error_text}")

        try:
            for _ in range(30):
                one()
            acc.clear()
            lat = []
            for _ in range(args.calls):
                t0 = time.perf_counter_ns()
                one()
                lat.append((time.perf_counter_ns() - t0) / 1e3)
        finally:
            ch.close()
            server.stop()
        out = {"p50_us": _p50(lat)}
        if native and acc["_relocate"]:
            out["relocations"] = len(acc["_relocate"])
            out["mean_us"] = {k: sum(v) / len(v) / 1e3
                              for k, v in acc.items() if v}
        return out

    res = {"bytes": SIZE, "calls": args.calls}
    res["native_plane_relocation"] = shape(True, 1, 1)
    res["native_device_put"] = shape(True, 1 << 20, 1)
    res["native_resident"] = shape(True, 1, 0)
    res["python_plane_relocation"] = shape(False, 1, 1)
    res["python_resident"] = shape(False, 1, 0)
    flags.set_flag("ici_device_plane_threshold", 1)
    plane = device_plane.plane()
    payload = mesh.device_put(data.to(mesh.device(1)), 1)
    lat = []
    for i in range(args.calls + 30):
        t0 = time.perf_counter_ns()
        t = plane.post_send(payload, 1, 0, mesh=mesh)
        plane.post_recv(t.uuid)
        if i >= 30:
            lat.append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    res["bare_post_send_post_recv_p50_us"] = _p50(lat)
    res["cpp_loop_p50_us"] = native_plane.native_ici_echo_p50_us(3000, 128)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
