"""rpc_press: a load generator for any protocol.

Reference: tools/rpc_press, ported from :mod:`brpc_tpu.tools.rpc_press`.
It fires requests built from a JSON body at a target qps (0 = as fast as
it can) and reports qps and latency through bvar::

    python -m brpc_tpu_torch.tools.rpc_press --server mem://echo \\
        --method EchoService.Echo --request '{"message":"x"}' \\
        --qps 1000 --duration 5 \\
        [--proto brpc_tpu_torch.proto.echo_pb2:EchoRequest,EchoResponse]

``--server`` takes an endpoint, a comma-separated endpoint list
(``mem://a,mem://b``, ``ici://0,ici://2``) or a naming url (``mesh://``,
``pod://name``, ``list://...``): one channel per resolved endpoint, the
workers spread over them round-robin, and the summary (the one a SIGINT
prints too) counts sent, errors and qps per endpoint, so one process can
drive a pod and see which member misbehaved.

Mixed classes, the admission layer's adversary: ``--priority`` takes one
band (``--priority 2``) or a ``band:weight,...`` mix (``0:1,3:3`` = one
critical call per three sheddable ones); ``--tenant`` takes a name or a
``tenant:weight,...`` mix.  Each request draws its (priority, tenant)
from the mixes in a fixed order, and the summary adds sent, shed
(ELIMIT), errors and latency per class.

Other modes: ``--fanout N`` drives one ParallelChannel over the first N
members with a sharded ``uint8`` operand that lives on the mesh's device
(``run_press_fanout``); ``--serving`` is the open-loop session generator
against a serving router's ``Router.Generate`` (``run_press_serving``).
``--bulk-plane``, ``--shm-stripes`` and ``--usercode-pool`` pin the
fabric's tiers and the usercode pool's backend for this process.
"""
from __future__ import annotations

import argparse
import importlib
import json
import signal
import sys
import threading
import time
from typing import List, Optional


def _load_classes(spec: str):
    mod_name, _, names = spec.partition(":")
    req_name, _, resp_name = names.partition(",")
    mod = importlib.import_module(
        mod_name.removesuffix(".py").replace("/", "."))
    return getattr(mod, req_name), getattr(mod, resp_name)


def parse_weighted_mix(spec: str, *, int_keys: bool = False) -> list:
    """``"a:2,b:1"`` -> the wheel ``["a", "a", "b"]``; a bare ``"a"`` has
    weight 1, and ``int_keys`` parses the keys as priority bands.  Each
    class stands in the wheel as often as its weight, so
    ``wheel[i % len(wheel)]`` draws the mix in a fixed order."""
    wheel = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weight = int(w) if w else 1
        except ValueError:
            raise SystemExit(f"rpc_press: bad weight in {part!r}")
        if weight < 1:
            raise SystemExit(f"rpc_press: weight must be >= 1 in {part!r}")
        key = name.strip()
        if int_keys:
            try:
                key = int(key)
            except ValueError:
                raise SystemExit(f"rpc_press: bad priority in {part!r}")
        wheel.extend([key] * weight)
    return wheel


def resolve_targets(server: str) -> List[str]:
    """One endpoint url per channel (``policy.naming.resolve_servers``);
    an empty resolution ends the run."""
    import brpc_tpu_torch.policy  # noqa: F401  (registers the schemes)
    from brpc_tpu_torch.policy.naming import resolve_servers
    try:
        return resolve_servers(server)
    except ValueError as e:
        raise SystemExit(f"rpc_press: {e}")


def _install_sigint(stop_evt: threading.Event):
    """A SIGINT stops issuing and keeps the summary; only the main thread
    can install it, elsewhere the default stays (returns None)."""
    try:
        return signal.signal(signal.SIGINT, lambda *_: stop_evt.set())
    except ValueError:
        return None


def _restore_sigint(prev) -> None:
    if prev is not None:
        signal.signal(signal.SIGINT, prev)


BULK_PLANES = ("auto", "shm", "uds", "inline")


def apply_bulk_plane(mode: str) -> None:
    """Pin the fabric's bulk tier for this process: "auto" keeps the route
    table's order (shm, then the bulk conn, then inline), "shm" turns the
    ring on (whether one bound shows in the summary's route counters),
    "uds" turns the ring off so payloads take the bulk conn, "inline"
    turns both off so everything rides the control channel."""
    if mode not in BULK_PLANES:
        raise SystemExit(f"rpc_press: unknown --bulk-plane {mode!r} "
                         f"(choose from {', '.join(BULK_PLANES)})")
    if mode == "auto":
        return
    import brpc_tpu_torch.ici.fabric  # noqa: F401  (defines the flags)
    from brpc_tpu_torch.butil import flags
    if mode == "shm":
        flags.set_flag("ici_fabric_shm", True)
    elif mode == "uds":
        flags.set_flag("ici_fabric_shm", False)
    elif mode == "inline":
        flags.set_flag("ici_fabric_shm", False)
        flags.set_flag("ici_fabric_bulk", False)


def apply_shm_stripes(n: int) -> None:
    """``--shm-stripes N``: N ring pairs a segment (0 keeps the default,
    min(4, cores)); the summary's ``shm_stripe_<i>`` route counters show
    which stripes carried bytes."""
    if n <= 0:
        return
    import brpc_tpu_torch.ici.fabric  # noqa: F401  (defines the flag)
    from brpc_tpu_torch.butil import flags
    flags.set_flag("ici_shm_stripes", n)


USERCODE_POOLS = ("auto", "pthread", "subinterp", "off")


def apply_usercode_pool(mode: str) -> None:
    """Pin the usercode pool's backend for the servers this process hosts
    (``mem://`` targets, its own ``ici://`` members): "auto" keeps each
    server's resolution, "pthread" and "subinterp" set the default before
    those servers start, "off" only records the pin (a load generator
    cannot unpool a remote server)."""
    if mode not in USERCODE_POOLS:
        raise SystemExit(f"rpc_press: unknown --usercode-pool {mode!r} "
                         f"(choose from {', '.join(USERCODE_POOLS)})")
    if mode in ("pthread", "subinterp"):
        from brpc_tpu_torch.rpc import usercode_pool
        try:
            usercode_pool.set_default_kind(mode)
        except ValueError as e:
            raise SystemExit(f"rpc_press: {e}")


def _in_process_servers() -> list:
    """(label, server) of every server this process hosts, each once: the
    loopback registry's ``mem://`` names, then the native door's
    ``ici://`` bindings."""
    from brpc_tpu_torch.ici import native_plane
    from brpc_tpu_torch.rpc import loopback
    with loopback._servers_lock:
        found = [(f"mem://{name}", srv)
                 for name, srv in loopback._servers.items()]
    with native_plane._server_bindings_lock:
        found += [(f"ici://{dev}", b._server)
                  for dev, b in native_plane._server_bindings.items()]
    out, seen = [], set()
    for label, srv in found:
        if id(srv) not in seen:
            seen.add(id(srv))
            out.append((label, srv))
    return out


def collect_usercode_pool_stats() -> dict:
    """The summary's pool block: the process's isolation capability (with
    the reason it cannot scale) and ``describe()`` of the pool of every
    server this process hosts."""
    from brpc_tpu_torch.rpc.usercode_pool import probe_isolation
    out: dict = {"isolation": probe_isolation()._asdict(), "servers": {}}
    for label, srv in _in_process_servers():
        if srv.usercode_pool is not None:
            out["servers"][label] = srv.usercode_pool.describe()
    return out


def collect_serving_stats() -> dict:
    """``describe_serving()`` of every serving service this process hosts
    (pool occupancy, step rate, batch occupancy, router weights), by
    ``<server>/<service>``; empty for a run against remote servers only
    (their /status page carries the same block)."""
    out: dict = {}
    for label, srv in _in_process_servers():
        for name, svc in srv.services().items():
            fn = getattr(svc, "describe_serving", None)
            if callable(fn):
                out[f"{label}/{name}"] = fn()
    return out


def run_press_fanout(server: str, method: str, n: int,
                     duration: float = 5.0, concurrency: int = 2,
                     shard_bytes: int = 512, out=sys.stderr) -> dict:
    """``--fanout N``: one ParallelChannel over the first N resolved
    members with a sharded operand per call, an ``(N, shard_bytes)``
    ``uint8`` tensor made once on the mesh's device.  The call takes the
    compiled collective route where the members registered a device body,
    the per-member loop where they did not or the route degraded.  The
    summary has the fan-out's p50/p99, the calls per route and the route
    table's collective counters, so a degraded pod shows."""
    import torch

    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import bvar, channels, rpc
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.ici.route import collective_stats
    targets = resolve_targets(server)
    if len(targets) < n:
        raise SystemExit(f"rpc_press: --fanout {n} needs {n} members, "
                         f"resolved {len(targets)}")
    targets = targets[:n]
    pc = channels.ParallelChannel()
    mapper = channels.ShardingCallMapper()
    merger = channels.CollectiveMerger(merge=channels.MERGE_GATHER,
                                       dtype="uint8",
                                       shard_shape=(shard_bytes,))
    for t in targets:
        ch = rpc.Channel()
        ch.init(t, options=rpc.ChannelOptions(timeout_ms=10000))
        pc.add_channel(ch, mapper=mapper, merger=merger)
    op = (torch.arange(n * shard_bytes) % 256).to(torch.uint8).reshape(
        n, shard_bytes).to(IciMesh.default().device(0))
    recorder = bvar.LatencyRecorder()
    sent = [0]
    errors_count = [0]
    routes: dict = {}
    lock = threading.Lock()
    deadline = time.monotonic() + duration
    stop_evt = threading.Event()
    prev_sigint = _install_sigint(stop_evt)

    def worker():
        while not stop_evt.is_set() and time.monotonic() < deadline:
            cntl = rpc.Controller()
            cntl.fanout_operand = op
            t0 = time.perf_counter_ns()
            pc.call_method(method, cntl, b"", None)
            lat_us = (time.perf_counter_ns() - t0) // 1000
            route = cntl.fanout_route or "none"
            with lock:
                sent[0] += 1
                routes[route] = routes.get(route, 0) + 1
                if cntl.failed():
                    errors_count[0] += 1
                else:
                    recorder << lat_us

    threads = [threading.Thread(target=worker)
               for _ in range(max(concurrency, 1))]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t_start
    _restore_sigint(prev_sigint)
    bvar.SamplerCollector.instance().sample_once()
    result = {
        "fanout": n,
        "members": targets,
        "sent": sent[0],
        "errors": errors_count[0],
        "qps": round(sent[0] / elapsed, 1) if elapsed else 0.0,
        "fanout_p50_us": recorder.latency_percentile(0.5),
        "fanout_p99_us": recorder.latency_percentile(0.99),
        "avg_latency_us": round(recorder.latency(), 1),
        "per_route": routes,
        "interrupted": stop_evt.is_set(),
    }
    cs = collective_stats()
    if cs:
        result["route_counters"] = cs
    print(json.dumps(result), file=out)
    return result


def run_press_serving(server: str, duration: float = 5.0,
                      arrival_rps: float = 20.0, batch_ratio: int = 3,
                      seq_range: str = "32-96", steps_range: str = "8-64",
                      max_sessions_inflight: int = 64, verify: bool = False,
                      out=sys.stderr) -> dict:
    """``--serving``: an open-loop session generator against a serving
    router's ``Router.Generate``.  Sessions arrive at a fixed rate whether
    or not earlier ones completed (the load a shedding admission layer
    must absorb), one interactive session (priority 0, tenant "inter",
    a short decode) per ``batch_ratio`` batch sessions (priority 3,
    tenant "bulk", the longest decode).  The summary has each tenant's
    sessions, sheds and failures, tokens/s a session at p50 and p99 and
    its latency; and, for every serving server this process hosts, the
    ``serving_status`` block, the KV load routes, each pool's
    ``kv_prefix`` block (shared blocks, prefix hits, the sharing ratio)
    and its ``kv_tiers`` block (resident and spilled sessions, demotes
    and restores, the spill plane's row and the process's migration
    ledger)."""
    import concurrent.futures

    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import errors as rpc_errors
    from brpc_tpu_torch.serving import kv_load_stats
    lo_seq, _, hi_seq = seq_range.partition("-")
    lo_steps, _, hi_steps = steps_range.partition("-")
    lo_seq, hi_seq = int(lo_seq), int(hi_seq or lo_seq)
    lo_steps, hi_steps = int(lo_steps), int(hi_steps or lo_steps)
    targets = resolve_targets(server)
    channels = []
    for t in targets:
        ch = rpc.Channel()
        ch.init(t, options=rpc.ChannelOptions(timeout_ms=30000,
                                              max_retry=0))
        channels.append(ch)
    reference = None
    if verify:
        from brpc_tpu_torch.examples.disagg_serving.model import \
            reference_generate
        from brpc_tpu_torch.ici.mesh import IciMesh
        dev = IciMesh.default().device(0)

        def reference(tokens, steps):
            return reference_generate(tokens, steps, device=dev)

    # plain lists, not bvar percentiles: a long batch decode's tokens/s
    # can be small, and the latency buckets would round it to 0
    classes = {
        name: {"sessions": 0, "ok": 0, "shed": 0, "fail": 0, "tokens": 0,
               "lat": [], "tps": []} for name in ("inter", "bulk")}
    lock = threading.Lock()
    mismatches = [0]
    stop_evt = threading.Event()
    prev_sigint = _install_sigint(stop_evt)

    def one_session(i: int) -> None:
        is_batch = (i % (batch_ratio + 1)) != 0
        tenant = "bulk" if is_batch else "inter"
        # draws fixed by the index (no RNG), so the load replays
        seq = lo_seq + (i * 13) % max(hi_seq - lo_seq + 1, 1)
        steps = (hi_steps if is_batch
                 else lo_steps + (i * 7) % max(
                     min(hi_steps // 2, hi_steps) - lo_steps + 1, 1))
        tokens = [(i * 31 + j) % 997 for j in range(seq)]
        cntl = rpc.Controller()
        cntl.priority = 3 if is_batch else 0
        cntl.tenant = tenant
        t0 = time.perf_counter_ns()
        resp = channels[i % len(channels)].call_method(
            "Router.Generate", cntl,
            EchoRequest(message=json.dumps(
                {"tokens": tokens, "steps": steps})), EchoResponse)
        lat_us = (time.perf_counter_ns() - t0) // 1000
        got = None
        if not cntl.failed():
            got = json.loads(resp.message)["tokens"]
            if reference is not None and got != reference(tokens, steps):
                with lock:
                    mismatches[0] += 1
        with lock:
            c = classes[tenant]
            c["sessions"] += 1
            if cntl.failed():
                if cntl.error_code_ in (rpc_errors.ELIMIT,
                                        rpc_errors.ELOGOFF):
                    c["shed"] += 1
                else:
                    c["fail"] += 1
            else:
                c["ok"] += 1
                c["tokens"] += len(got)
                c["lat"].append(lat_us)
                if lat_us > 0:
                    c["tps"].append(len(got) * 1e6 / lat_us)

    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=max_sessions_inflight)
    interval = 1.0 / max(arrival_rps, 0.1)
    t_start = time.monotonic()
    deadline = t_start + duration
    next_fire = t_start
    issued = 0
    while not stop_evt.is_set():
        now = time.monotonic()
        if now >= deadline:
            break
        if now < next_fire:
            time.sleep(min(next_fire - now, 0.01))
            continue
        # the arrival clock moves on whether or not sessions completed
        next_fire += interval
        pool.submit(one_session, issued)
        issued += 1
    pool.shutdown(wait=True)
    elapsed = time.monotonic() - t_start
    _restore_sigint(prev_sigint)

    def pct(vals, q):
        if not vals:
            return -1.0
        vals = sorted(vals)
        return round(vals[min(int(len(vals) * q), len(vals) - 1)], 1)

    total_tokens = sum(c["tokens"] for c in classes.values())
    result = {
        "serving": True,
        "targets": targets,
        "arrival_rps": arrival_rps,
        "issued": issued,
        "elapsed_s": round(elapsed, 2),
        "tokens_per_s": round(total_tokens / elapsed, 1) if elapsed
        else 0.0,
        "verify": verify,
        "mismatches": mismatches[0],
        "interrupted": stop_evt.is_set(),
        "per_tenant": {
            name: {
                "sessions": c["sessions"], "ok": c["ok"],
                "shed": c["shed"], "failures": c["fail"],
                "tokens": c["tokens"],
                "latency_p50_us": pct(c["lat"], 0.5),
                "latency_p99_us": pct(c["lat"], 0.99),
                "session_tokens_per_s_p50": pct(c["tps"], 0.5),
                "session_tokens_per_s_p99": pct(c["tps"], 0.99),
            } for name, c in classes.items()},
    }
    stats = collect_serving_stats()
    if stats:
        # the KV counters are process-wide: a run against remote servers
        # only would report its own zeros as theirs, so all three blocks
        # come only with an in-process serving server
        result["serving_status"] = stats
        result["kv_load_routes"] = kv_load_stats()
        pools = {label: blk["pool"] for label, blk in stats.items()
                 if isinstance(blk.get("pool"), dict)}
        prefix = {label: p["prefix"] for label, p in pools.items()
                  if "prefix" in p}
        if prefix:
            result["kv_prefix"] = prefix
        tiers = {label: p["tiers"] for label, p in pools.items()
                 if "tiers" in p}
        if tiers:
            result["kv_tiers"] = tiers
    print(json.dumps(result), file=out)
    for ch in channels:
        ch.close()
    return result


def run_press(server: str, method: str, request_json: str,
              qps: int = 0, duration: float = 5.0, concurrency: int = 8,
              proto: Optional[str] = None, protocol: str = "tpu_std",
              priority: Optional[str] = None, tenant: Optional[str] = None,
              max_retry: Optional[int] = None,
              bulk_plane: str = "auto", shm_stripes: int = 0,
              usercode_pool: str = "auto",
              out=sys.stderr) -> dict:
    import brpc_tpu_torch.policy  # noqa: F401  (registers protocols)
    from brpc_tpu_torch import bvar, rpc
    from brpc_tpu_torch.codec import json2pb
    from brpc_tpu_torch.ici.route import route_stats
    from brpc_tpu_torch.rpc import errors as rpc_errors
    apply_bulk_plane(bulk_plane)
    apply_shm_stripes(shm_stripes)
    apply_usercode_pool(usercode_pool)

    if proto:
        req_cls, resp_cls = _load_classes(proto)
        request = json2pb.dict_to_pb(json.loads(request_json or "{}"),
                                     req_cls)
    else:
        resp_cls = None
        request = (request_json or "").encode()

    pri_wheel = parse_weighted_mix(priority, int_keys=True) \
        if priority else []
    tenant_wheel = parse_weighted_mix(tenant) if tenant else []
    # a stride coprime with the tenant wheel decorrelates it from the
    # priority wheel (equal lengths would pin each band to one tenant)
    ten_stride = 1
    if tenant_wheel:
        ten_stride = next(s for s in (7, 11, 13, 17, 19, 23, 1)
                          if len(tenant_wheel) % s != 0 or s == 1)
    targets = resolve_targets(server)
    channels = []
    for t in targets:
        copts = rpc.ChannelOptions(protocol=protocol, timeout_ms=10000)
        if max_retry is not None:
            copts.max_retry = max_retry
        ch = rpc.Channel()
        ch.init(t, options=copts)
        channels.append(ch)
    recorder = bvar.LatencyRecorder()
    errors_count = [0]
    sent = [0]
    per_ep = {t: {"sent": 0, "errors": 0} for t in targets}
    # per (priority, tenant) class: sent, shed (ELIMIT), errors, latency
    per_class: dict = {}
    lock = threading.Lock()
    deadline = time.monotonic() + duration
    interval = concurrency / qps if qps > 0 else 0.0
    # a SIGINT stops issuing; the calls in flight complete and the summary
    # still prints
    stop_evt = threading.Event()
    prev_sigint = _install_sigint(stop_evt)

    def worker(wid: int):
        next_fire = time.monotonic()
        i = 0
        while not stop_evt.is_set() and time.monotonic() < deadline:
            if interval:
                now = time.monotonic()
                if now < next_fire:
                    time.sleep(min(next_fire - now, 0.05))
                    continue
                next_fire += interval
            # each worker starts at its own offset in the endpoint list, so
            # N workers cover N endpoints
            idx = (wid + i) % len(targets)
            cntl = rpc.Controller()
            pri = pri_wheel[(wid + i) % len(pri_wheel)] if pri_wheel \
                else None
            ten = tenant_wheel[(wid + ten_stride * i) % len(tenant_wheel)] \
                if tenant_wheel else ""
            if pri is not None:
                cntl.priority = pri
            if ten:
                cntl.tenant = ten
            i += 1
            t0 = time.perf_counter_ns()
            channels[idx].call_method(method, cntl, request, resp_cls)
            lat_us = (time.perf_counter_ns() - t0) // 1000
            shed = (cntl.error_code_ == rpc_errors.ELIMIT
                    and cntl.retry_after_ms > 0)
            with lock:
                sent[0] += 1
                per_ep[targets[idx]]["sent"] += 1
                if pri_wheel or tenant_wheel:
                    ckey = f"p{pri if pri is not None else '-'}" + \
                        (f"/{ten}" if ten else "")
                    cls = per_class.get(ckey)
                    if cls is None:
                        cls = per_class[ckey] = {
                            "sent": 0, "shed": 0, "errors": 0,
                            "rec": bvar.LatencyRecorder()}
                    cls["sent"] += 1
                    if shed:
                        cls["shed"] += 1
                    elif cntl.failed():
                        cls["errors"] += 1
                    else:
                        cls["rec"] << lat_us
                if cntl.failed():
                    errors_count[0] += 1
                    per_ep[targets[idx]]["errors"] += 1
                else:
                    recorder << lat_us

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(concurrency)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()            # an interrupted worker finishes its call
    elapsed = time.monotonic() - t_start
    _restore_sigint(prev_sigint)
    bvar.SamplerCollector.instance().sample_once()
    result = {
        "sent": sent[0],
        "errors": errors_count[0],
        "qps": round(sent[0] / elapsed, 1),
        "avg_latency_us": round(recorder.latency(), 1),
        "max_latency_us": recorder.max_latency(),
        "p99_latency_us": recorder.latency_percentile(0.99),
        "elapsed_s": round(elapsed, 2),
        "interrupted": stop_evt.is_set(),
        "bulk_plane": bulk_plane,
        "shm_stripes": shm_stripes,
        "usercode_pool": usercode_pool,
        # the isolation capability (a host that cannot scale says why)
        # and the pools of this process's servers
        "usercode_pool_stats": collect_usercode_pool_stats(),
    }
    # which byte mover carried the payloads (empty off the fabric)
    rs = route_stats()
    if rs:
        result["routes"] = rs
    if len(targets) > 1:
        result["per_endpoint"] = {
            t: {**c, "qps": round(c["sent"] / elapsed, 1)}
            for t, c in per_ep.items()}
    if per_class:
        result["per_class"] = {
            k: {"sent": c["sent"], "shed": c["shed"],
                "errors": c["errors"],
                "avg_latency_us": round(c["rec"].latency(), 1),
                "p99_latency_us": c["rec"].latency_percentile(0.99)}
            for k, c in sorted(per_class.items())}
    print(json.dumps(result), file=out)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--server", required=True,
                    help="endpoint, comma-separated endpoint list, or "
                         "naming url (mesh://, pod://name, list://...)")
    ap.add_argument("--method", default=None,
                    help="full method name (required except with "
                         "--serving, which drives Router.Generate)")
    ap.add_argument("--request", default="{}")
    ap.add_argument("--qps", type=int, default=0, help="0 = unthrottled")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--proto", default=None,
                    help="module:RequestCls,ResponseCls")
    ap.add_argument("--protocol", default="tpu_std")
    ap.add_argument("--priority", default=None,
                    help="priority band (0=critical..3=sheddable) or a "
                         "band:weight mix, e.g. '0:1,3:3'")
    ap.add_argument("--tenant", default=None,
                    help="tenant name or tenant:weight mix, e.g. 'a:2,b:1'")
    ap.add_argument("--max-retry", type=int, default=None,
                    help="per-call retry budget (shed retries honor the "
                         "server's retry_after_ms hint)")
    ap.add_argument("--bulk-plane", default="auto", choices=BULK_PLANES,
                    help="pin the fabric's bulk tier for this run: auto "
                         "(shm, then uds/tcp, then inline), shm, uds (shm "
                         "off), inline (both descriptor planes off); the "
                         "summary reports the route counters")
    ap.add_argument("--usercode-pool", default="auto",
                    choices=USERCODE_POOLS,
                    help="pin the usercode pool's backend for servers "
                         "hosted in this process (auto keeps each "
                         "server's resolution; off records the pin); the "
                         "summary reports the isolation capability and "
                         "each server's pool")
    ap.add_argument("--shm-stripes", type=int, default=0,
                    help="N shm ring stripes a segment (0 = min(4, "
                         "cores)); per-stripe counters appear in the "
                         "summary's routes")
    ap.add_argument("--fanout", type=int, default=0,
                    help="drive ONE ParallelChannel over the first N "
                         "resolved members (the compiled collective route "
                         "where registered, per-member RPCs otherwise); "
                         "the summary adds the fan-out's p50/p99 and the "
                         "calls per route")
    ap.add_argument("--fanout-shard-bytes", type=int, default=512,
                    help="bytes per member shard in --fanout mode")
    ap.add_argument("--serving", action="store_true",
                    help="open-loop serving session generator against a "
                         "Router.Generate front door: interactive and "
                         "batch tenants at a fixed arrival rate; the "
                         "summary reports each tenant's tokens/s p50/p99 "
                         "and the pools' occupancy")
    ap.add_argument("--serving-arrival-rps", type=float, default=20.0,
                    help="session arrivals per second (open loop: the "
                         "clock never waits for completions)")
    ap.add_argument("--serving-batch-ratio", type=int, default=3,
                    help="batch sessions per interactive session")
    ap.add_argument("--serving-seq", default="32-96",
                    help="prompt length range, e.g. 32-96")
    ap.add_argument("--serving-steps", default="8-64",
                    help="decode steps range: interactive draws from the "
                         "low half, batch takes the high bound")
    ap.add_argument("--serving-verify", action="store_true",
                    help="hold every completion against the one-process "
                         "reference (slow: a reference prefill a session)")
    args = ap.parse_args(argv)
    if args.serving:
        run_press_serving(args.server, duration=args.duration,
                          arrival_rps=args.serving_arrival_rps,
                          batch_ratio=args.serving_batch_ratio,
                          seq_range=args.serving_seq,
                          steps_range=args.serving_steps,
                          max_sessions_inflight=max(args.concurrency, 8),
                          verify=args.serving_verify, out=sys.stdout)
        return 0
    if not args.method:
        raise SystemExit("rpc_press: --method is required "
                         "(except with --serving)")
    if args.fanout > 0:
        run_press_fanout(args.server, args.method, args.fanout,
                         duration=args.duration,
                         concurrency=args.concurrency,
                         shard_bytes=args.fanout_shard_bytes,
                         out=sys.stdout)
        return 0
    run_press(args.server, args.method, args.request, args.qps,
              args.duration, args.concurrency, args.proto, args.protocol,
              priority=args.priority, tenant=args.tenant,
              max_retry=args.max_retry, bulk_plane=args.bulk_plane,
              shm_stripes=args.shm_stripes,
              usercode_pool=args.usercode_pool, out=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
