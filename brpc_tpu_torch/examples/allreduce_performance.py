"""All-reduce bandwidth (the example/rdma_performance analogue), ported
from ``examples/allreduce_performance.py``: a data-parallel gradient
push-pull over the mesh, through ``Collectives.all_reduce`` (the JAX
example's psum) and ``ring.ring_all_reduce`` (its explicit ring).  GB/s is
the input bytes over host time per call, synchronized.

    python -m brpc_tpu_torch.examples.allreduce_performance            # card
    python -m brpc_tpu_torch.examples.allreduce_performance --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from brpc_tpu_torch.examples.common import setup_mesh
from brpc_tpu_torch.ici.collective import Collectives
from brpc_tpu_torch.ici.ring import ring_all_reduce


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size-mb", type=int, default=64)
    args = ap.parse_args(argv)
    mesh = setup_mesh(args.device)
    coll = Collectives(mesh)
    n = mesh.size
    elems = args.size_mb * 1024 * 1024 // 4
    grads = coll.shard(torch.ones(n, max(elems // n, 1),
                                  dtype=torch.float32))
    nbytes = grads.shape.numel() * 4
    dev = mesh.device(0)
    for name, fn in (("psum", coll.all_reduce),
                     ("explicit ring", lambda x: ring_all_reduce(x, mesh))):
        fn(grads)                        # warm
        _sync(dev)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(grads)
        _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        print(f"{name:14s}: {nbytes / 1e6:.0f} MB allreduce over {n} ranks "
              f"in {dt * 1e3:.1f} ms -> {nbytes / dt / 1e9:.2f} GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
