"""Where the KV pool's host tier spends a demote and a restore, on one card.

    python3 -m brpc_tpu_torch.tools.profile_tiers [--sessions N]

Builds the pool of ``chip_smoke.py``'s phase 9 on the card — 65,536
device blocks and 65,536 pinned host blocks of 16 tokens x 1,024 B — and
drives it directly, without the RPC stack:

  * loads ``--sessions`` sessions of 2,048 tokens (random bytes made on
    the card), the ones past the device arena demoting a session each;
  * restores ``--restores`` demoted sessions through ``get``;
  * splits the host time of both by part: the victim picker, the tier
    copies (each copy plus its stream sync, as the pool times them), the
    host crc32 over the host arena, and the rest;
  * times one block run's copy both ways, host-timed as the pool does and
    CUDA-event-timed, on the pool's own arenas;
  * times the spill picker on the full pool with and without one shared
    prefix in it (with one, it groups candidates by walking every block
    of every candidate).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object.  Needs a card (``--device cpu`` runs it on the host to rehearse,
with no device number worth keeping).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import types
import zlib

import torch

BLOCK_TOKENS, BYTES_PER_TOKEN = 16, 1024


class _Parts:
    """Accumulated ns and calls per part, from wrappers around the pool's
    own methods."""

    def __init__(self):
        self.ns = {}
        self.calls = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.ns[name] = self.ns.get(name, 0) + \
                    time.perf_counter_ns() - t0
                self.calls[name] = self.calls.get(name, 0) + 1
        return timed

    def take(self) -> dict:
        out = {k: {"ms": v / 1e6, "calls": self.calls[k]}
               for k, v in self.ns.items()}
        self.ns, self.calls = {}, {}
        return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=576)
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--blocks", type=int, default=65536)
    ap.add_argument("--restores", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_tiers: no CUDA device")
    from ..serving import KvPoolOptions, PagedKvPool
    from ..serving import kv_pool as kv_pool_mod
    from .timing import nvidia_smi_line

    pool = PagedKvPool(KvPoolOptions(
        bytes_per_token=BYTES_PER_TOKEN, num_blocks=args.blocks,
        block_tokens=BLOCK_TOKENS, host_blocks=args.blocks,
        use_timers=False), device=dev)
    parts = _Parts()
    for name in ("_pick_victims_locked", "_tier_copy", "_chained_crcs",
                 "_demote_session_locked"):
        setattr(pool, name, parts.wrap(name, getattr(pool, name)))
    kv_pool_mod.zlib = types.SimpleNamespace(
        crc32=parts.wrap("crc32", zlib.crc32))
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "sessions": args.sessions, "tokens": args.tokens,
           "device_blocks": args.blocks, "host_blocks": args.blocks}
    try:
        fits = args.blocks * BLOCK_TOKENS // args.tokens
        load_ms = []
        for i in range(args.sessions):
            if i == fits:
                parts.take()              # the loads that demote, apart
            rows = torch.randint(0, 256, (args.tokens, BYTES_PER_TOKEN),
                                 dtype=torch.uint8, device=dev,
                                 generator=gen)
            _sync(dev)
            t0 = time.perf_counter_ns()
            pool.load(f"s{i}", rows, last_token=i)
            load_ms.append((time.perf_counter_ns() - t0) / 1e6)
        out["load_fits_p50_ms"] = statistics.median(load_ms[:fits])
        out["load_demotes_p50_ms"] = statistics.median(load_ms[fits:]) \
            if args.sessions > fits else None
        out["load_demotes_parts"] = parts.take()
        spilled = sorted(pool.spilled_sessions(), key=lambda s: int(s[1:]))
        restore_ms = []
        for s in spilled[:args.restores]:
            t0 = time.perf_counter_ns()
            ok = pool.get(s) is not None
            restore_ms.append((time.perf_counter_ns() - t0) / 1e6)
            if not ok:
                raise SystemExit(f"profile_tiers: restore of {s} failed")
        out["restore_p50_ms"] = statistics.median(restore_ms)
        out["restore_parts"] = parts.take()
        tiers = pool.describe()["tiers"]
        out["tiers"] = {k: v for k, v in tiers.items() if k != "migration"}

        # one run of a session's blocks, both ways, on the pool's arenas
        n = args.tokens // BLOCK_TOKENS
        d_run, h_run = pool._store[:n], pool._host_store[:n]
        nbytes = d_run.numel()
        host_ms, event_ms = [], []
        for _ in range(20):
            _sync(dev)
            t0 = time.perf_counter_ns()
            h_run.copy_(d_run, non_blocking=dev.type == "cuda")
            _sync(dev)
            host_ms.append((time.perf_counter_ns() - t0) / 1e6)
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                h_run.copy_(d_run, non_blocking=True)
                b.record()
                b.synchronize()
                event_ms.append(a.elapsed_time(b))
        out["run_copy"] = {
            "bytes": nbytes,
            "host_timed_p50_ms": statistics.median(host_ms),
            "event_timed_p50_ms": (statistics.median(event_ms)
                                   if event_ms else None)}

        # the spill picker on the full pool, without and with sharing
        def pick_ms(spill: bool) -> float:
            ts = []
            for _ in range(5):
                with pool._lock:
                    t0 = time.perf_counter_ns()
                    pool._pick_victims_locked(n, 2, spill=spill)
                    ts.append((time.perf_counter_ns() - t0) / 1e6)
            return statistics.median(ts)

        picker = {"plain_ms": pick_ms(False), "spill_ms": pick_ms(True)}
        with pool._lock:
            victim = min(pool._tables.values(), key=lambda s: s.last_used)
        pool.release(victim.session)
        prefix = pool.materialize(max(pool._tables, key=lambda s: int(
            s[1:]) if s[1:].isdigit() else -1))[:BLOCK_TOKENS]
        pool.load("shared", prefix, last_token=0)
        picker["spill_with_shared_ms"] = pick_ms(True)
        picker["shared_blocks"] = pool.describe()["prefix"]["shared_blocks"]
        out["picker"] = picker
    finally:
        pool.close()
        kv_pool_mod.zlib = zlib
    if dev.type == "cuda":
        print(nvidia_smi_line(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
