"""chip_smoke.py — build the port's kernels and drive its main path on one
NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero (and prints no result) without one.
Phases, each fatal on failure:

  1. build      compile csrc/p2p_copy.cu with nvcc (sm_90a) and load it
  2. kernel     p2p_copy against its plain version at 4 KiB, 65,537 B
                (misaligned source), 4 MiB, 4 MiB (source and destination
                misaligned) and 256 MiB: bit-exact, with CUDA-event times
                (median of 25 single launches, L2 flushed before each;
                kernel, plain version and Tensor.copy_ timed in turns,
                twice, each keeping the better median) beside the HBM
                bound 2·n / 3.35 TB/s
  3. plane      the device-plane echo of the JAX package's
                bench_device_plane: IciMesh(ranks=8) on the card, server on
                ici://0 answering inline, payload owned by rank 1,
                threshold 1 so every attachment rides the plane; 300 calls
                at 4 KiB (p50/p99 µs), 16 at 4 MiB (GB/s)
  4. echo       the default 64 KiB threshold with an Echo service that
                returns the attachment: 64 KiB and 4 MiB ride the plane,
                4 KiB takes mesh.device_put; returned bytes must match

Launch counts are zeroed just before phase 3 and read after phase 4: the
kernel's launches must equal the plane's transfers.  The line before the
last is the ``kernels`` JSON; the last line is the device JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
TIMED_RUNS = 25
SPIN_CYCLES = 200_000              # ~100 µs of GPU spin ahead of each timing


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def event_ms(fn, flush: torch.Tensor, runs: int = TIMED_RUNS,
             warm: int = 3) -> float:
    """Device time of ``fn``: the median over ``runs`` single calls, each
    between two CUDA events, with the 50 MB L2 cache flushed (``flush``
    rewritten) before each.  A spin kernel ahead of the start event keeps
    the stream busy while the host enqueues ``fn``, so the host's launch
    cost stays out of the interval."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, runs: int = 500) -> float:
    """Host cost of enqueueing ``fn`` once (µs), over ``runs`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / runs * 1e6


def phase_kernel(p2p_copy, p2p_copy_plain, dev) -> list:
    rows = []
    cases = [("4 KiB", 4096, 0, 0), ("65,537 B src+3", 65537, 3, 0),
             ("4 MiB", 4 << 20, 0, 0), ("4 MiB src+1 dst+7", 4 << 20, 1, 7),
             ("256 MiB", 256 << 20, 0, 0)]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, n, so, do in cases:
        src_buf = torch.randint(0, 256, (n + so,), dtype=torch.uint8,
                                device=dev, generator=gen)
        src = src_buf[so:]
        dst = torch.empty(n + do, dtype=torch.uint8, device=dev)[do:]
        ref = torch.empty(n, dtype=torch.uint8, device=dev)
        lib = torch.empty(n, dtype=torch.uint8, device=dev)
        p2p_copy(src, dst)
        p2p_copy_plain(src, ref)
        torch.cuda.synchronize()
        err = int((dst.int() - ref.int()).abs().max().item())
        check(err == 0, f"p2p_copy differs from its plain version at "
                        f"{label}: max abs err {err}")
        check(torch.equal(ref, src), f"plain version wrong at {label}")
        # two rounds in turns (kernel, plain, library): each keeps the
        # better of its two medians
        timed = {"ms": lambda: p2p_copy(src, dst),
                 "plain_ms": lambda: p2p_copy_plain(src, ref),
                 "library_ms": lambda: lib.copy_(src)}
        best = dict.fromkeys(timed, float("inf"))
        for _ in range(2):
            for key, fn in timed.items():
                best[key] = min(best[key], event_ms(fn, flush))
        ms, plain_ms, library_ms = (best["ms"], best["plain_ms"],
                                    best["library_ms"])
        check(torch.equal(dst, src), f"p2p_copy wrong after timing, {label}")
        bound_ms = 2 * n / HBM_BYTES_PER_S * 1e3
        row = {"label": label, "bytes": n, "src_offset": so,
               "dst_offset": do, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
               "host_us": host_us(lambda: p2p_copy(src, dst)),
               "library_host_us": host_us(lambda: lib.copy_(src))}
        rows.append(row)
        print(f"kernel {label:>18}: p2p_copy {ms * 1e3:8.2f} us  "
              f"copy_ {library_ms * 1e3:8.2f} us  bound "
              f"{bound_ms * 1e3:8.2f} us  share {bound_ms / ms:6.1%}  "
              f"host {row['host_us']:6.2f} vs {row['library_host_us']:6.2f} "
              f"us  err {err}", flush=True)
        del src_buf, src, dst, ref, lib
    del flush
    return rows


def make_payload(mesh, nbytes: int, rank: int, seed: int):
    data = np.random.default_rng(seed).integers(0, 256, nbytes,
                                                dtype=np.uint8)
    return data, mesh.device_put(torch.from_numpy(data), rank)


def phase_plane_echo(rpc, mesh, plane, p2p_copy, EchoRequest, EchoResponse):
    from brpc_tpu_torch.butil import flags

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            # consume, don't bounce: one plane transfer per frame piece,
            # so the transfer counter proves the datapath
            response.message = str(len(cntl.request_attachment))
            done()

    flags.set_flag("ici_device_plane_threshold", 1)
    server = rpc.Server(rpc.ServerOptions(usercode_inline=True))
    server.add_service(Sink())
    check(server.start("ici://0") == 0, "server start on ici://0")
    ch = rpc.Channel()
    ch.init("ici://0", rpc.ChannelOptions(timeout_ms=30000, max_retry=0))

    def drive(payload, n, warm):
        lat = []
        for i in range(n + warm):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            t0 = time.perf_counter_ns()
            resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="d"),
                                  EchoResponse)
            t1 = time.perf_counter_ns()
            check(not cntl.failed(), f"Sink.Push failed: {cntl.error_text}")
            check(resp.message == str(payload.shape[0]),
                  f"server saw {resp.message} bytes, sent {payload.shape[0]}")
            if i >= warm:
                lat.append((t1 - t0) / 1000.0)
        return sorted(lat)

    try:
        out = {}
        calls = 0
        before = plane.stats()
        launches0 = p2p_copy.launches
        _, small = make_payload(mesh, 4096, 1, seed=1)
        lat = drive(small, 300, warm=20)
        calls += 320
        out["p50_us_4k"] = lat[len(lat) // 2]
        out["p99_us_4k"] = lat[int(len(lat) * 0.99)]
        big = 4 << 20
        _, payload = make_payload(mesh, big, 1, seed=2)
        lat = drive(payload, 16, warm=4)
        calls += 20
        out["gbps_4m"] = 16 * big / (sum(lat) / 1e6) / 1e9
        out["p50_us_4m"] = lat[len(lat) // 2]
        torch.cuda.synchronize()
        after = plane.stats()
        out["calls"] = calls
        out["plane_transfers"] = after["transfers"] - before["transfers"]
        out["launches"] = p2p_copy.launches - launches0
        check(out["plane_transfers"] >= calls,
              f"{out['plane_transfers']} plane transfers for {calls} calls")
        check(out["launches"] == out["plane_transfers"],
              f"p2p_copy launched {out['launches']} times for "
              f"{out['plane_transfers']} plane transfers")
    finally:
        ch.close()
        server.stop()
        flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    return out


def phase_default_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                       EchoResponse):
    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(usercode_inline=True))
    server.add_service(Echo())
    check(server.start("ici://0") == 0, "server start on ici://0")
    ch = rpc.Channel()
    ch.init("ici://0", rpc.ChannelOptions(timeout_ms=30000, max_retry=0))
    out = {}
    launches0 = p2p_copy.launches
    try:
        for nbytes, on_plane in ((4096, False), (64 << 10, True),
                                 (4 << 20, True)):
            data, payload = make_payload(mesh, nbytes, 1, seed=nbytes)
            t0 = plane.stats()["transfers"]
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("Echo.Echo", cntl,
                                  EchoRequest(message=f"m{nbytes}"),
                                  EchoResponse)
            check(not cntl.failed(), f"Echo {nbytes} B: {cntl.error_text}")
            check(resp.message == f"m{nbytes}", "echoed message differs")
            got = cntl.response_attachment.to_bytes()
            check(got == data.tobytes(),
                  f"Echo {nbytes} B: returned bytes differ from sent")
            ranks = {mesh.rank_of(r.block.data)
                     for r in cntl.response_attachment.device_refs()}
            check(ranks == {1}, f"echoed bytes owned by ranks {ranks}")
            moved = plane.stats()["transfers"] - t0
            check((moved > 0) == on_plane,
                  f"Echo {nbytes} B: {moved} plane transfers, expected "
                  f"{'some' if on_plane else 'none'}")
            out[f"transfers_{nbytes}"] = moved
        torch.cuda.synchronize()
        out["launches"] = p2p_copy.launches - launches0
        check(out["launches"] == sum(v for k, v in out.items()
                                     if k.startswith("transfers_")),
              f"echo phase: launches {out['launches']} != transfers")
    finally:
        ch.close()
        server.stop()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.ici import device_plane
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.ici.p2p_copy import p2p_copy, p2p_copy_plain
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {count}", flush=True)

    # 1. build
    build_s = p2p_copy.build()
    print(f"build: p2p_copy built and loaded in {build_s:.2f} s", flush=True)

    # 2. kernel vs plain version
    dev = torch.device("cuda", 0)
    rows = phase_kernel(p2p_copy, p2p_copy_plain, dev)

    # 3-4. the main path: ici:// echo through the device plane
    mesh = IciMesh(ranks=8)
    check(mesh.device_type == "cuda", "default mesh is not on the card")
    IciMesh.set_default(mesh)
    plane = device_plane.plane()
    p2p_copy.launches = 0
    bench = phase_plane_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                             EchoResponse)
    print("plane echo: " + json.dumps(bench), flush=True)
    echo = phase_default_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                              EchoResponse)
    print("default-threshold echo: " + json.dumps(echo), flush=True)
    main_launches = p2p_copy.launches
    check(main_launches == bench["launches"] + echo["launches"],
          "launch count moved outside the main path")
    check(main_launches > 0, "the main path never launched p2p_copy")
    print("plane stats: " + json.dumps(plane.stats()), flush=True)

    head = next(r for r in rows if r["label"] == "4 MiB")
    kernels = {"kernels": [{
        "name": "p2p_copy",
        "route": "cuda",
        "source": "brpc_tpu_torch/csrc/p2p_copy.cu",
        "replaces": "brpc_tpu/ici/device_plane.py:428",
        "tpu_counterpart": "DevicePlane._pallas_body.kern "
                           "(brpc_tpu/ici/device_plane.py:395-444)",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_abs_diff": max(r["max_abs_err"] for r in rows),
        "shape": f"{head['bytes']} B",
        "ms": head["ms"],
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "by_size": rows,
    }]}
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
