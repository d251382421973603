"""The overload leg of bench.py (``_overload_one_plane``) on the port and on
the JAX package, in turns, on one host.

Each leg is bench.py's shape: a server of capacity 2 / 20 ms = 100 rps
(``max_concurrency`` 2, handlers on the backup pool, an admission queue
bound of half a service time), a priority-0 caller at half capacity for
1.2 s (the unloaded p99), then 10x capacity for 3 s over 4 tenants in a
3:1 low:high mix, one paced thread per stream, message "o" and no
attachment.  Both packages serve on ``ici://5`` of a CPU mesh, each on its
Python plane (the JAX server with ``native_ici=False``), so the legs
differ only by package.  Every leg runs in a process of its own, and the
packages alternate.  The verdict is bench.py's ``pass_p99_bound``: the
served priority-0 p99 under overload within 2x its unloaded p99.
``--attach N`` gives every call an N-byte DEVICE attachment owned by rank
6 or 7 (by stream), which the server returns, as chip_smoke.py's phase 10
does; both packages move it on their device planes.

    python3 sweeps/overload_ab.py [--rounds 3] [--attach 4194304]
    python3 sweeps/overload_ab.py --leg port         # one leg, one line

This script imports both packages (the port and the reference), so it
lives outside the port's package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVICE_MS, MAX_CONC, FACTOR = 20.0, 2, 10
UNLOADED_S, OVERLOAD_S = 1.2, 3.0
TENANTS = ("t0", "t1", "t2", "t3")
WARM_CALLS = 5


def _p99(lats):
    if not lats:
        return -1.0
    lats = sorted(lats)
    return lats[min(int(len(lats) * 0.99), len(lats) - 1)]


def _packages(which: str):
    """(rpc, AdmissionOptions, EchoRequest, EchoResponse, server kwargs)
    of one package, its CPU mesh set up."""
    sys.path.insert(0, ROOT)
    if which == "jax":
        import brpc_tpu.policy  # noqa: F401
        from brpc_tpu import rpc
        from brpc_tpu.rpc.admission import AdmissionOptions
        from tests.echo_pb2 import EchoRequest, EchoResponse
        return rpc, AdmissionOptions, EchoRequest, EchoResponse, \
            {"native_ici": False}
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc.admission import AdmissionOptions
    IciMesh.set_default(IciMesh(ranks=8, device="cpu"))
    return rpc, AdmissionOptions, EchoRequest, EchoResponse, {}


def _attachments(which: str, nbytes: int) -> dict:
    """One seeded attachment per client rank, on that rank of the
    package's mesh; the device planes engaged for them."""
    import numpy as np
    data = {rank: np.random.default_rng(rank).integers(
        0, 256, nbytes, dtype=np.uint8) for rank in (6, 7)}
    if which == "jax":
        import jax
        from brpc_tpu.butil import flags
        from brpc_tpu.ici.mesh import IciMesh
        put = lambda a, r: jax.device_put(a, IciMesh.default().device(r))
    else:
        import torch
        from brpc_tpu_torch.butil import flags
        from brpc_tpu_torch.ici.mesh import IciMesh
        put = lambda a, r: IciMesh.default().device_put(
            torch.from_numpy(a), r)
    flags.set_flag("ici_device_plane_host_mesh", True)
    flags.set_flag("ici_socket_window_bytes", 256 << 20)
    return {rank: put(a, rank) for rank, a in data.items()}


def run_leg(which: str, attach: int = 0) -> dict:
    rpc, AdmissionOptions, EchoRequest, EchoResponse, extra = \
        _packages(which)
    bank = _attachments(which, attach) if attach else {}

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            time.sleep(SERVICE_MS / 1000.0)
            response.message = request.message
            if attach:
                cntl.response_attachment.append(cntl.request_attachment)
            done()

    opts = rpc.ServerOptions()
    opts.max_concurrency = MAX_CONC
    opts.usercode_in_pthread = True
    opts.usercode_backup_threads = MAX_CONC + 2
    opts.admission = AdmissionOptions(max_queue_ms=SERVICE_MS / 2.0,
                                      queue_capacity=64)
    for k, v in extra.items():
        setattr(opts, k, v)
    server = rpc.Server(opts)
    server.add_service(Echo())
    assert server.start("ici://5") == 0
    capacity = MAX_CONC / (SERVICE_MS / 1000.0)

    def run_phase(spec, duration):
        stats, lock = {}, threading.Lock()
        stop = time.monotonic() + duration

        def worker(pri, tenant, rate, wid):
            ch = rpc.Channel()
            ch.init("ici://5", options=rpc.ChannelOptions(timeout_ms=2000,
                                                          max_retry=0))
            interval = 1.0 / rate
            next_fire = time.monotonic() + (wid % 7) * 0.003
            while time.monotonic() < stop:
                now = time.monotonic()
                if now < next_fire:
                    time.sleep(min(next_fire - now, 0.02))
                    continue
                next_fire += interval
                cntl = rpc.Controller()
                cntl.priority = pri
                cntl.tenant = tenant
                if attach:
                    cntl.request_attachment.append_device_array(
                        bank[6 + wid % 2])
                t0 = time.perf_counter_ns()
                ch.call_method("Echo.Echo", cntl, EchoRequest(message="o"),
                               EchoResponse)
                lat_us = (time.perf_counter_ns() - t0) / 1000.0
                with lock:
                    c = stats.setdefault((pri, tenant), {
                        "ok": 0, "shed": 0, "issued": 0, "lats": []})
                    c["issued"] += 1
                    if not cntl.failed():
                        c["ok"] += 1
                        c["lats"].append(lat_us)
                    else:
                        c["shed"] += 1

        threads = [threading.Thread(target=worker, args=(*s, i))
                   for i, s in enumerate(spec)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return stats

    base = run_phase([(0, "t0", capacity / 2.0)], UNLOADED_S)
    spec = []
    per_tenant = FACTOR * capacity / len(TENANTS)
    for t in TENANTS:
        spec += [(0, t, per_tenant * 0.25), (3, t, per_tenant * 0.375),
                 (3, t, per_tenant * 0.375)]
    over = run_phase(spec, OVERLOAD_S)
    server.stop()
    hi = [x for (p, _), c in over.items() if p == 0 for x in c["lats"]]
    base_lats = base[(0, "t0")]["lats"]
    unloaded = _p99(base_lats)
    # beside bench.py's ratio, one whose unloaded p99 leaves out the
    # first calls of the process (connection set-up, first dispatch)
    warm = _p99(base_lats[WARM_CALLS:])
    loaded = _p99(hi)
    issued = sum(c["issued"] for c in over.values())
    return {"package": which, "attach": attach,
            "hi_p99_unloaded_us": unloaded,
            "hi_p99_overload_us": loaded,
            "hi_p99_ratio": loaded / unloaded if unloaded > 0 else -1.0,
            "hi_p99_unloaded_warm_us": warm,
            "hi_p99_ratio_warm": loaded / warm if warm > 0 else -1.0,
            "pass_p99_bound": unloaded > 0 and loaded <= 2.0 * unloaded,
            "offered_rps_measured": issued / OVERLOAD_S,
            "hi_served": len(hi),
            "shed": sum(c["shed"] for c in over.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", choices=("port", "jax"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--attach", type=int, default=0)
    args = ap.parse_args(argv)
    if args.leg:
        print(json.dumps(run_leg(args.leg, args.attach)), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    rows = []
    for r in range(args.rounds):
        order = ("port", "jax") if r % 2 == 0 else ("jax", "port")
        for which in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--leg", which,
                 "--attach", str(args.attach)],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
                return 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            rows.append(row)
            print(json.dumps(row), flush=True)
    for which in ("port", "jax"):
        ratios = sorted(r["hi_p99_ratio"] for r in rows
                        if r["package"] == which)
        warm = sorted(r["hi_p99_ratio_warm"] for r in rows
                      if r["package"] == which)
        print(f"{which}: priority-0 p99 ratio {ratios}, without the first "
              f"{WARM_CALLS} unloaded calls {warm}, passes "
              f"{sum(r['pass_p99_bound'] for r in rows if r['package'] == which)}"
              f"/{len(ratios)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
