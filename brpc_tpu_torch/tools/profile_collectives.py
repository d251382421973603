"""Where a call of the collectives path spends its time, on one card.

    python3 -m brpc_tpu_torch.tools.profile_collectives [--mib 64] [--calls 10]

Builds ``IciMesh(ranks=8)`` on the card and ``--mib`` MiB of float32
gradients sharded over it (``chip_smoke.py``'s collectives phase), then
runs each route ``--calls`` times under ``torch.profiler``:
``Collectives.all_reduce`` (psum), ``ring.ring_all_reduce``,
``pallas_ring.ring_all_reduce`` and ``pallas_ring.ring_all_gather``, a
``CollectiveChannel`` matvec over an (8, 4096, 4096) weight, and ring and
Ulysses attention at seq 4096 (8 heads, dim 128).  For each it reports the
wall time per call, the device's busy time per call and idle share, and
the operations that take the most device time and the most host time.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def profile_calls(fn, calls: int, top: int = 6) -> dict:
    """``fn`` ``calls`` times under torch.profiler, after one warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = [e for e in events if e.self_device_time_total > 0
           and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "wall_us_per_call": wall_us / calls,
        "device_busy_us_per_call": busy_us / calls,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_top": [{"name": e.key[:80], "count": e.count,
                        "us_per_call": e.self_device_time_total / calls}
                       for e in sorted(dev, key=lambda e:
                                       e.self_device_time_total,
                                       reverse=True)[:top]],
        "host_top": [{"name": e.key[:80], "count": e.count,
                      "us_per_call": e.self_cpu_time_total / calls}
                     for e in host[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=64,
                    help="float32 gradient MiB over the 8 ranks")
    ap.add_argument("--calls", type=int, default=10,
                    help="profiled calls per route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_collectives: needs a CUDA device", file=sys.stderr)
        return 1
    from .. import channels
    from ..ici import pallas_ring, ring
    from ..ici import ring_attention as ra
    from ..ici.collective import Collectives
    from ..ici.mesh import IciMesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = IciMesh(ranks=8)
    n = mesh.size
    coll = Collectives(mesh)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    grads = coll.shard(torch.randn((n, args.mib * 2**18 // n),
                                   generator=gen, device="cuda"))
    ch = channels.CollectiveChannel(mesh)
    ch.register("Shard.PartialMatVec", lambda w, x: w @ x,
                merge=channels.MERGE_SUM)
    w = ch.shard(torch.rand((n, 4096, 4096), generator=gen, device="cuda"))
    x = ch.replicate(torch.rand((4096,), generator=gen, device="cuda"))
    seq, heads, dim = 4096, 8, 128
    q, k, v = (coll.shard(torch.randn((n, seq // n, heads, dim),
                                      generator=gen, device="cuda"))
               for _ in range(3))
    routes = {
        "psum": lambda: coll.all_reduce(grads),
        "ring.ring_all_reduce": lambda: ring.ring_all_reduce(grads),
        "pallas_ring.ring_all_reduce":
            lambda: pallas_ring.ring_all_reduce(grads),
        "pallas_ring.ring_all_gather":
            lambda: pallas_ring.ring_all_gather(grads),
        "CollectiveChannel matvec":
            lambda: ch.call("Shard.PartialMatVec", w, x),
        "ring_attention": lambda: ra.ring_attention(q, k, v),
        "ulysses_attention": lambda: ra.ulysses_attention(q, k, v),
    }
    out = {"mib": args.mib, "calls": args.calls, "routes": {}}
    for name, fn in routes.items():
        calls = args.calls if "attention" not in name else 3
        out["routes"][name] = profile_calls(fn, calls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
