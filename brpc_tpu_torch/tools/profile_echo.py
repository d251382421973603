"""Where a 4 KiB device-plane echo call spends its time, on one card.

    python3 -m brpc_tpu_torch.tools.profile_echo [--calls N]

Drives the same echo as ``chip_smoke.py``'s plane phase (IciMesh(ranks=8)
on the card, server on ici://0 answering inline, a 4 KiB attachment owned
by rank 1, threshold 1 so it rides the device plane), then measures two
windows apart from each other:

  * the device's idle share: ``torch.profiler`` device time of every
    kernel and copy over the wall time of 30 calls;
  * sampled host stacks over ``--calls`` calls: each sample of the
    caller and the device poller thread is charged to the innermost frame
    in this package and the leaf function it was in.  The sampler shortens
    ``sys.setswitchinterval`` while it runs, so these calls are slower
    than unprofiled ones; read the shares, not the times.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

import torch

SIZE = 4096


def device_busy_share(fn, top: int = 0) -> dict:
    """Run ``fn`` under torch.profiler: device time of every kernel and
    copy over the window's wall time; with ``top``, also the ``top``
    operations with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    out = {"wall_us": wall_us, "device_busy_us": busy_us,
           "device_idle_share": 1.0 - busy_us / wall_us}
    if top:
        dev.sort(key=lambda e: -e.self_device_time_total)
        out["top_device"] = [{"name": e.key[:80], "count": e.count,
                              "us": e.self_device_time_total}
                             for e in dev[:top]]
    return out


def sample_stacks(fn, threads=("MainThread", "device_poller_cuda:0"),
                  interval_s: float = 0.0002, role_of=None,
                  top: int = 16) -> list:
    """Run ``fn`` while a sampler reads the stacks of ``threads``; returns
    the ``top`` most frequent (thread, package site, leaf) with their
    share of that thread's samples.  ``role_of(name, frame)``, where
    given, replaces ``threads``: it names the role a thread's sample is
    charged to, or None to skip it."""
    pkg = os.sep + "brpc_tpu_torch" + os.sep
    counts: collections.Counter = collections.Counter()
    per_thread: collections.Counter = collections.Counter()
    stop = threading.Event()
    if role_of is None:
        def role_of(name, frame):
            return name if name in threads else None

    def sampler() -> None:
        me = threading.get_ident()
        while not stop.is_set():
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                name = (None if ident == me else
                        role_of(names.get(ident, ""), frame))
                if name is None:
                    continue
                f, site = frame, "outside the package"
                while f is not None:
                    if pkg in f.f_code.co_filename:
                        site = (os.path.basename(f.f_code.co_filename)
                                + ":" + f.f_code.co_name)
                        break
                    f = f.f_back
                counts[(name, site, frame.f_code.co_name)] += 1
                per_thread[name] += 1
            time.sleep(interval_s)

    # a short switch interval lets the sampler take the GIL between
    # samples; with the default 5 ms it would only see the points where
    # the sampled threads release the GIL
    switch = sys.getswitchinterval()
    sys.setswitchinterval(interval_s / 2)
    t = threading.Thread(target=sampler, name="stack_sampler", daemon=True)
    t.start()
    try:
        fn()
    finally:
        stop.set()
        t.join(5.0)
        sys.setswitchinterval(switch)
    return [{"thread": k[0], "site": k[1], "leaf": k[2],
             "share": n / per_thread[k[0]]}
            for k, n in counts.most_common(top)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200,
                    help="calls in the stack-sampled window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_echo: needs a CUDA device", file=sys.stderr)
        return 1
    from .. import policy  # noqa: F401  (registers tpu_std)
    from .. import rpc
    from ..butil import flags
    from ..ici.mesh import IciMesh
    from ..proto.echo_pb2 import EchoRequest, EchoResponse

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            response.message = str(len(cntl.request_attachment))
            done()

    mesh = IciMesh(ranks=8)
    IciMesh.set_default(mesh)
    flags.set_flag("ici_device_plane_threshold", 1)
    server = rpc.Server(rpc.ServerOptions(usercode_inline=True))
    server.add_service(Sink())
    if server.start("ici://0") != 0:
        print("profile_echo: server start on ici://0 failed", file=sys.stderr)
        return 1
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    payload = mesh.device_put(
        torch.randint(0, 256, (SIZE,), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1)), 1)

    def drive(n: int) -> None:
        for _ in range(n):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="d"),
                                  EchoResponse)
            if cntl.failed() or resp.message != str(SIZE):
                raise RuntimeError(f"Sink.Push failed: {cntl.error_text}")

    try:
        drive(20)                                 # warm: build, streams
        out = {"bytes": SIZE,
               "profile": device_busy_share(lambda: drive(30)),
               "stack_calls": args.calls,
               "stacks": sample_stacks(lambda: drive(args.calls))}
    finally:
        ch.close()
        server.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
