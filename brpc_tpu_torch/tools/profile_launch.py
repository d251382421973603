"""profile_launch — where the host time of one p2p_copy launch goes, on
one NVIDIA card.

    python3 -m brpc_tpu_torch.tools.profile_launch [--calls 500]

Host µs per call (perf_counter over ``--calls`` calls, after a warm-up,
ending in a synchronize) of each layer of the launch path, from the bare
ctypes call up to ``p2p_copy(src, dst)``, beside ``Tensor.copy_`` and an
empty kernel, at 4 KiB and 4 MiB.  Each is measured twice: with the device
idle between calls, and with a spin queued ahead so that every call finds
the device busy (``--calls`` stays under the driver's queue of pending
launches, so the busy calls never wait for room).  The last line is the
JSON of every row.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .timing import empty_kernel, nvidia_smi_line


def per_call_us(fn, calls: int, busy_cycles: int) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    if busy_cycles:
        torch.cuda._sleep(busy_cycles)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    from brpc_tpu_torch.ici.p2p_copy import _check, p2p_copy

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_launch: needs a CUDA card", file=sys.stderr)
        return 1
    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    rec = p2p_copy.record(0)
    empty = empty_kernel()
    empty_rec = empty.record(0)
    raw_empty, raw = empty._fn, p2p_copy._fn
    stream = torch.cuda.current_stream().cuda_stream
    # a spin that outlasts every call of a busy measurement (~30 µs each)
    busy = int(args.calls * 30 * 2000)
    rows = []
    for label, n in (("4 KiB", 4096), ("4 MiB", 4 << 20)):
        src = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        sp, dp = src.data_ptr(), dst.data_ptr()
        layers = {
            "empty kernel (ctypes)": lambda: raw_empty(stream),
            "empty kernel (launch)": lambda: empty.launch(empty_rec),
            "p2p_copy_launch (ctypes)": lambda: raw(sp, dp, n, stream),
            "CudaKernel.launch": lambda: p2p_copy.launch(rec, sp, dp, n),
            "_check": lambda: _check(src, dst),
            "p2p_copy(src, dst)": lambda: p2p_copy(src, dst),
            "Tensor.copy_": lambda: dst.copy_(src),
        }
        for state, cycles in (("idle", 0), ("busy", busy)):
            for name, fn in layers.items():
                us = per_call_us(fn, args.calls, cycles)
                rows.append({"size": label, "device": state, "layer": name,
                             "host_us": us})
                print(f"{label:>6} device {state}: {name:>26} {us:7.2f} us",
                      flush=True)
        del src, dst
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
