"""Paced overload clients: bench.py's overload leg (``_overload_one_plane``)
on the port, one copy for every caller.

``chip_smoke.py`` phase 10 runs the clients in the server's own process;
phase 17 (e) runs them in a fabric peer (:mod:`.fabric_peer`'s
``Sink.Overload``), the server in the other process.  Each client stream
is ``(priority, tenant, rps, rank)``: one thread on its own Channel with
``max_retry`` 0, firing at its pace; request i carries pattern
``i % patterns`` of its rank's seeded attachment bank, and the server
checks and returns it.  Before the unloaded window, untimed warm-up calls
(every pattern of every rank) open the connection, the sequencer and the
device leg's mappings, so the unloaded p99 is a warm one.

Stats are keyed ``"<priority>/<tenant>"`` (JSON-safe, so a peer returns
them as they are); :func:`summarize` reads both windows the same way for
every caller.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

Stream = Tuple[int, str, float, int]      # priority, tenant, rps, rank

WARM_CALLS = 2                 # untimed calls per (rank, pattern)


def attachment_bank(mesh, ranks: Sequence[int], payload: int,
                    patterns: int, device) -> Dict[int, List[torch.Tensor]]:
    """``{rank: [pattern 0, ...]}``: seeded bytes, one flat uint8 row per
    pattern, owned by its rank on ``device``."""
    return {r: [mesh.own(torch.from_numpy(np.random.default_rng(
        100 * r + k).integers(0, 256, payload, dtype=np.uint8)).to(device),
        r) for k in range(patterns)] for r in ranks}


def attachment_tensor(att) -> torch.Tensor:
    """The bytes of a received attachment as one flat uint8 tensor on its
    rank (a view when it arrived as one DEVICE block).  Raises ValueError
    when a part of it arrived in host memory."""
    from ..butil.iobuf import DEVICE
    segs = []
    for i in range(att.backing_block_num()):
        r = att.backing_block(i)
        if r.block.kind != DEVICE:
            raise ValueError("an attachment arrived in host memory")
        segs.append(r.block.data[r.offset:r.offset + r.length])
    return segs[0] if len(segs) == 1 else torch.cat(segs)


def overload_streams(capacity: float, factor: float, tenants: Sequence[str],
                     ranks: Sequence[int]) -> Tuple[List[Stream],
                                                    List[Stream]]:
    """bench.py's two windows: the unloaded one (one priority-0 stream at
    half the capacity) and the overload (``factor`` x capacity split over
    the tenants: a priority-0 stream and two priority-3 ones each, the
    tenants alternating between the two client ranks)."""
    base = [(0, tenants[0], capacity / 2.0, ranks[0])]
    per_tenant = factor * capacity / len(tenants)
    over: List[Stream] = []
    for j, t in enumerate(tenants):
        rank = ranks[j % len(ranks)]
        over += [(0, t, per_tenant * 0.25, rank),
                 (3, t, per_tenant * 0.375, rank),
                 (3, t, per_tenant * 0.375, rank)]
    return base, over


def _new_stats() -> dict:
    return {"ok": 0, "shed": 0, "shed_with_hint": 0, "err": 0, "issued": 0,
            "bad": 0, "lats": [], "codes": [], "in_call_s": 0.0,
            "max_call_ms": 0.0}


def _call(rpc, ch, bank, rank, k, pri, tenant, tensor_of):
    """One Echo.Echo carrying pattern k of ``rank``; ``(cntl, latency µs,
    came back equal or None when the call failed)``."""
    from ..proto.echo_pb2 import EchoRequest, EchoResponse
    cntl = rpc.Controller()
    cntl.priority = pri
    cntl.tenant = tenant
    cntl.request_attachment.append_device_array(bank[rank][k])
    t0 = time.perf_counter_ns()
    ch.call_method("Echo.Echo", cntl, EchoRequest(message=f"{rank}:{k}"),
                   EchoResponse)
    lat_us = (time.perf_counter_ns() - t0) / 1000.0
    back = None
    if not cntl.failed():
        back = torch.equal(tensor_of(cntl.response_attachment), bank[rank][k])
    return cntl, lat_us, back


def _record(rpc, stats, key, cntl, lat_us, back) -> None:
    c = stats.setdefault(key, _new_stats())
    c["issued"] += 1
    c["in_call_s"] += lat_us / 1e6
    c["max_call_ms"] = max(c["max_call_ms"], lat_us / 1e3)
    if back is not None:
        c["ok"] += 1
        c["bad"] += not back
        c["lats"].append(lat_us)
    elif cntl.error_code_ == rpc.errors.ELIMIT:
        c["shed"] += 1
        c["shed_with_hint"] += cntl.retry_after_ms > 0
    else:
        c["err"] += 1
        c["codes"].append(cntl.error_code_)


def _channel(rpc, target):
    ch = rpc.Channel()
    ch.init(target, options=rpc.ChannelOptions(timeout_ms=2000, max_retry=0))
    return ch


def run_window(rpc, target: str, streams: Sequence[Stream], duration: float,
               bank, tensor_of: Callable, chans: list) -> dict:
    """One paced thread per stream for ``duration`` seconds, each on its
    own Channel (appended to ``chans``).  Raises when a client thread did
    not finish."""
    stats: dict = {}
    lock = threading.Lock()
    stop = time.monotonic() + duration
    patterns = len(next(iter(bank.values())))

    def worker(pri, tenant, rate, rank, wid):
        ch = _channel(rpc, target)
        chans.append(ch)
        interval = 1.0 / rate
        next_fire = time.monotonic() + (wid % 7) * 0.003
        i = 0
        while time.monotonic() < stop:
            now = time.monotonic()
            if now < next_fire:
                time.sleep(min(next_fire - now, 0.02))
                continue
            next_fire += interval
            k = i % patterns
            i += 1
            res = _call(rpc, ch, bank, rank, k, pri, tenant, tensor_of)
            with lock:
                _record(rpc, stats, f"{pri}/{tenant}", *res)

    threads = [threading.Thread(target=worker, args=(*s, i), daemon=True)
               for i, s in enumerate(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration + 30)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("overload clients did not finish")
    return stats


def run_overload(rpc, target: str, base: Sequence[Stream],
                 over: Sequence[Stream], unloaded_s: float,
                 overload_s: float, bank, tensor_of: Callable) -> dict:
    """The warm-ups (:data:`WARM_CALLS` per rank and pattern, priority 0,
    one after another), then the unloaded and the overload window:
    ``{"warm": stats, "base": stats, "over": stats}``.  Every Channel to
    the target shares the process's one connection, and closing one fails
    it: so all of them close only at the end, and both windows run on the
    connection the warm-ups opened."""
    warm: dict = {}
    chans = [_channel(rpc, target)]
    try:
        for rank, rows in bank.items():
            for k in range(len(rows)):
                for _ in range(WARM_CALLS):
                    res = _call(rpc, chans[0], bank, rank, k, 0, base[0][1],
                                tensor_of)
                    _record(rpc, warm, "warm", *res)
        return {"warm": warm,
                "base": run_window(rpc, target, base, unloaded_s, bank,
                                   tensor_of, chans),
                "over": run_window(rpc, target, over, overload_s, bank,
                                   tensor_of, chans)}
    finally:
        for ch in chans:
            ch.close()


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(int(len(xs) * q), len(xs) - 1)]


def summarize(res: dict, overload_s: float, tenants: Sequence[str]) -> dict:
    """What both callers read off :func:`run_overload`'s result: the
    priority-0 p99 of each window and their ratio (bench.py bounds it at
    2), the offered rps measured, goodput by tenant, sheds (with a
    retry_after_ms hint), errors, payloads that came back different and
    attachments that came back, over all three windows."""
    hi: List[float] = []
    hi_by_tenant: Dict[str, int] = {}
    low_ok = shed = hinted = issued = errs = 0
    codes: List[int] = []
    streams = {}
    for key, c in res["over"].items():
        pri, tenant = key.split("/", 1)
        streams[f"{tenant}/p{pri}"] = {
            k: round(c[k], 3) if isinstance(c[k], float) else c[k]
            for k in ("issued", "ok", "shed", "in_call_s", "max_call_ms")}
        if pri == "0":
            hi.extend(c["lats"])
            hi_by_tenant[tenant] = c["ok"]
        else:
            low_ok += c["ok"]
        shed += c["shed"]
        hinted += c["shed_with_hint"]
        issued += c["issued"]
        errs += c["err"]
        codes += c["codes"]
    base_lats = [x for c in res["base"].values() for x in c["lats"]]
    windows = [c for w in res.values() for c in w.values()]
    mean_share = sum(hi_by_tenant.values()) / len(tenants)
    out = {
        "hi_p99_unloaded_us": _pct(base_lats, 0.99) if base_lats else -1.0,
        "hi_p99_overload_us": _pct(hi, 0.99) if hi else -1.0,
        "offered_rps_measured": issued / overload_s,
        "hi_goodput_by_tenant": hi_by_tenant, "low_goodput": low_ok,
        "shed": shed, "shed_with_retry_after": hinted, "errors": errs,
        "codes": sorted(set(codes)),
        "tenant_min_share_ratio": (min(hi_by_tenant.values()) / mean_share
                                   if mean_share else -1.0),
        "mean_share": mean_share,
        "bad": sum(c["bad"] for c in windows),
        "attachments_back": sum(c["ok"] for c in windows),
        "streams": streams}
    out["hi_p99_ratio"] = out["hi_p99_overload_us"] / out["hi_p99_unloaded_us"]
    return out
