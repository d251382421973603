"""The native ici:// door's fused client path against its unfused chain.

    python3 -m brpc_tpu_torch.tools.fused_ab [--pairs 10] [--calls 400]
                                             [--device cpu]

Drives phase 3's Sink echo of ``chip_smoke.py`` (IciMesh(ranks=8), server
on ici://0, a 4 KiB attachment owned by rank 1 and relocated on the device
plane, threshold 1) on two servers: one answering inline
(``usercode_inline=True``) and one with the default dispatch (a tasklet
per request).  A sync call takes ``ChannelBinding.call_fused``; the
unfused chain is ``Channel.call_method``'s body, which async calls take.
For each server it runs ``--pairs`` pairs of ``--calls`` timed calls
(after 30 warm-up calls), the two in turns, each pair in the other order
from the last, switching the channel binding's private switch in place.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object: per server, each path's per-run p50 (µs), their median and
quartiles, the median of the paired differences (fused minus unfused)
and the pairs the fused path won.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

SIZE = 4096
WARMUP = 30


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return {"q1": q[0], "median": q[1], "q3": q[2]}


def set_fused(ch, on: bool) -> None:
    """Switch the channel's sync calls between the fused path and the
    unfused chain."""
    ch._native_ici._fused = on


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fused_ab: needs a CUDA device (or --device cpu)",
              file=sys.stderr)
        return 1
    from .. import policy  # noqa: F401  (registers tpu_std)
    from .. import rpc
    from ..butil import flags
    from ..ici.mesh import IciMesh
    from ..proto.echo_pb2 import EchoRequest, EchoResponse
    from .timing import nvidia_smi_line

    if args.device == "cuda":
        print(nvidia_smi_line(), flush=True)
        mesh = IciMesh(ranks=8)
    else:
        flags.set_flag("ici_device_plane_host_mesh", True)
        mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    flags.set_flag("ici_device_plane_threshold", 1)

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            response.message = str(len(cntl.request_attachment))
            done()

    data = torch.arange(SIZE).to(torch.uint8)
    payload = mesh.device_put(data.to(mesh.device(1)), 1)

    def run_server(inline: bool) -> dict:
        server = rpc.Server(rpc.ServerOptions(usercode_inline=inline))
        server.add_service(Sink())
        if server.start("ici://0") != 0:
            raise RuntimeError("server start on ici://0 failed")
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000,
                                                      max_retry=0))

        def one():
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("Sink.Push", cntl,
                                  EchoRequest(message="d"), EchoResponse)
            if cntl.failed() or resp.message != str(SIZE):
                raise RuntimeError(f"Sink.Push failed: {cntl.error_text}")

        runs = {True: [], False: []}
        try:
            for _ in range(WARMUP):
                one()
            binding = server._native_ici
            if binding is None or ch._native_ici is None:
                raise RuntimeError("the call did not take the native door")
            n0 = binding.requests()
            for i in range(args.pairs):
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    set_fused(ch, on)
                    for _ in range(WARMUP):
                        one()
                    lat = []
                    for _ in range(args.calls):
                        t0 = time.perf_counter_ns()
                        one()
                        lat.append((time.perf_counter_ns() - t0) / 1e3)
                    runs[on].append(_p50(lat))
            native_n = binding.requests() - n0
        finally:
            ch.close()
            server.stop()
        diffs = [a - b for a, b in zip(runs[True], runs[False])]
        return {"fused_p50_us": runs[True], "unfused_p50_us": runs[False],
                "fused": _quartiles(runs[True]),
                "unfused": _quartiles(runs[False]),
                "paired_diff_median_us": statistics.median(diffs),
                "pairs_fused_faster": sum(d < 0 for d in diffs),
                "native_requests": native_n}

    res = {"bytes": SIZE, "pairs": args.pairs, "calls": args.calls,
           "device": args.device,
           "inline_server": run_server(True),
           "default_server": run_server(False)}
    if args.device == "cuda":
        torch.cuda.synchronize()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
