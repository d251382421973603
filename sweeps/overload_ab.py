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

``--stages`` warms the connection with 16 untimed calls, turns rpcz on
in both packages and splits every served priority-0 call of both windows
into its stages, read off its client and server spans (one process, one
monotonic clock): the client's stack up to the write (``client_send``),
the request's way into the server's input (``request_wire``), the server's
``tpu_std_server_<stage>`` points up to its write (the input queue, the
admission queue's wait, parse, handler and encode; ``server_other`` is
the gaps between them), the answer's way back from the server's write
until the client span ends (``response``), and the caller's work outside
its span, its wake-up after the answer among it (``client_rest``).  They
sum to the call's latency; the server's ``write`` call is read beside
them.  Each leg then also
prints, per window, the p50 and p99 of each stage and the mean split of
the slowest tenth of the calls, and the summary gives each stage's range
over the rounds.

    python3 sweeps/overload_ab.py [--rounds 3] [--attach 4194304] [--stages]
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
STAGE_WARM_CALLS = 16


def _p99(lats):
    if not lats:
        return -1.0
    lats = sorted(lats)
    return lats[min(int(len(lats) * 0.99), len(lats) - 1)]


# a call's latency, from the caller's clock to its answer: the client's
# stack up to the write, the request's way into the server's input, the
# server's stages up to its write, the answer's way back (the server's
# write call and the delivery) until the client span ends, and the
# caller's own work outside its span (its wake-up after the answer).  They
# sum to the latency; the server's ``write`` is read beside them: the
# client can take the answer before that call returns
_SERVER = ("input_queue", "admission_wait", "parse", "handler", "encode")
_STAGES = ("client_send", "request_wire", *_SERVER, "server_other",
           "response", "client_rest")
_READ = (*_STAGES, "write", "latency")


def _stage_row(spans, lat: float):
    """One traced call's split (µs) from its client and server spans (one
    process, one monotonic clock), or None when a span or stamp is
    missing."""
    cli = [s for s in spans if s.kind == "client"]
    srv = [s for s in spans if s.kind == "server"]
    if not cli or not srv or not cli[0].end_us:
        return None
    cli, srv = cli[0], srv[0]
    issued = [t for t, a in cli.annotations if a.startswith("issue ")]
    row = dict.fromkeys(_READ, 0.0)
    recv = write_start = None
    for t, ann in srv.annotations:
        name, _, val = ann.partition("_us=")
        if not val.isdigit():
            continue
        if name == "queue":
            # the input queue first, then (if it queued) admission's; the
            # first one's stamp less its wait is when the request was cut
            if recv is None:
                recv = t - int(val)
                row["input_queue"] += float(val)
            else:
                row["admission_wait"] += float(val)
        elif name in row:
            row[name] += float(val)
            if name == "write":
                write_start = t - int(val)
    if not issued or recv is None or write_start is None:
        return None
    row["client_send"] = float(issued[0] - cli.start_us)
    row["request_wire"] = float(recv - issued[0])
    row["server_other"] = (write_start - recv) - sum(row[k]
                                                     for k in _SERVER)
    row["response"] = float(cli.end_us - write_start)
    row["client_rest"] = lat - (cli.end_us - cli.start_us)
    row["latency"] = lat
    return row


def _stage_split(find_trace, traced) -> dict:
    """{stage: p50, p99} and the slowest tenth's mean split over the
    traced priority-0 calls ``[(trace_id, client_latency_us)]``."""
    rows = [r for r in (_stage_row(find_trace(tid), lat)
                        for tid, lat in traced) if r is not None]
    if not rows:
        return {"traced": 0}
    out = {"traced": len(rows)}
    for k in _READ:
        vals = sorted(r[k] for r in rows)
        out[k] = {"p50": vals[len(vals) // 2], "p99": _p99(vals)}
    tail = sorted(rows, key=lambda r: r["latency"])[-max(len(rows) // 10,
                                                         1):]
    out["slowest_tenth_mean"] = {k: sum(r[k] for r in tail) / len(tail)
                                 for k in _READ}
    return out


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
    return rpc, AdmissionOptions, EchoRequest, EchoResponse, \
        {"native_ici": False}


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


def run_leg(which: str, attach: int = 0, stages: bool = False) -> dict:
    rpc, AdmissionOptions, EchoRequest, EchoResponse, extra = \
        _packages(which)
    bank = _attachments(which, attach) if attach else {}
    if stages:
        if which == "jax":
            from brpc_tpu.butil import flags
            from brpc_tpu.rpc.span import find_trace
        else:
            from brpc_tpu_torch.butil import flags
            from brpc_tpu_torch.rpc.span import find_trace
        flags.set_flag("rpcz_enabled", True)
        flags.set_flag("rpcz_keep", 1 << 20)

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
        traced = []
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
                        if stages and pri == 0 and cntl.trace_id:
                            traced.append((cntl.trace_id, lat_us))
                    else:
                        c["shed"] += 1

        threads = [threading.Thread(target=worker, args=(*s, i))
                   for i, s in enumerate(spec)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats["traced"] = traced
        return stats

    if stages:
        # a warm connection, as chip_smoke.py's phase 17 (e) has: the
        # split then reads no connection set-up or first dispatch
        ch = rpc.Channel()
        ch.init("ici://5", options=rpc.ChannelOptions(timeout_ms=2000,
                                                      max_retry=0))
        for _ in range(STAGE_WARM_CALLS):
            cntl = rpc.Controller()
            if attach:
                cntl.request_attachment.append_device_array(bank[6])
            ch.call_method("Echo.Echo", cntl, EchoRequest(message="o"),
                           EchoResponse)
            assert not cntl.failed(), cntl.error_text
    base = run_phase([(0, "t0", capacity / 2.0)], UNLOADED_S)
    spec = []
    per_tenant = FACTOR * capacity / len(TENANTS)
    for t in TENANTS:
        spec += [(0, t, per_tenant * 0.25), (3, t, per_tenant * 0.375),
                 (3, t, per_tenant * 0.375)]
    over = run_phase(spec, OVERLOAD_S)
    server.stop()
    split = {}
    if stages:
        split = {"unloaded": _stage_split(find_trace, base.pop("traced")),
                 "overload": _stage_split(find_trace, over.pop("traced"))}
    else:
        base.pop("traced")
        over.pop("traced")
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
            "shed": sum(c["shed"] for c in over.values()),
            **({"stages": split} if stages else {})}


def _stage_ranges(rows, which: str) -> dict:
    """Each stage's [min, max] over one package's rounds, in ms: the p50
    and p99 of both windows and the unloaded slowest tenth's mean."""
    out = {}
    for window in ("unloaded", "overload"):
        splits = [r["stages"][window] for r in rows
                  if r["package"] == which and r["stages"][window]["traced"]]
        if not splits:
            continue
        for k in _READ:
            reads = {"p50": [sp[k]["p50"] for sp in splits],
                     "p99": [sp[k]["p99"] for sp in splits]}
            if window == "unloaded":
                reads["slowest_tenth"] = [sp["slowest_tenth_mean"][k]
                                          for sp in splits]
            for stat, vals in reads.items():
                out[f"{window}.{k}.{stat}"] = [round(min(vals) / 1e3, 2),
                                               round(max(vals) / 1e3, 2)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", choices=("port", "jax"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--attach", type=int, default=0)
    ap.add_argument("--stages", action="store_true")
    args = ap.parse_args(argv)
    if args.leg:
        print(json.dumps(run_leg(args.leg, args.attach, args.stages)),
              flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    rows = []
    for r in range(args.rounds):
        order = ("port", "jax") if r % 2 == 0 else ("jax", "port")
        for which in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--leg", which,
                 "--attach", str(args.attach)]
                + (["--stages"] if args.stages else []),
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
        if args.stages:
            print(f"{which}: stages, ms over the rounds "
                  f"{json.dumps(_stage_ranges(rows, which))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
