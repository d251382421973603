"""brpc_tpu_torch.serving — the serving subsystem on the card.

Port of :mod:`brpc_tpu.serving`, the pieces the disaggregated
prefill/decode path runs:

  * :mod:`.kv_pool` — ``PagedKvPool``: fixed-size blocks in device
    memory, a free list, per-session block tables, admission-aware
    eviction, TimerThread expiry, copy-on-write prefix sharing and fills
    outside the pool lock;
  * :mod:`.scheduler` — ``ContinuousBatchScheduler``: one batched decode
    step on the device per tick over the active session set;
  * :mod:`.kv_source` — the KV handoff's last leg: a LoadKv attachment
    (the device plane's output tensor) scattered straight into the
    reserved pool blocks;
  * :mod:`.router` — ``LoadAwareRouter``: prefill→decode routing by load
    through the LALB balancer.

Not ported yet: the host tier, ``write_rows``, migration, the
autoscaler, the ``pod://`` router and the shm/native KV routes.
"""
from .kv_pool import (KvPoolOptions, PagedKvPool, PoolSaturated,
                      SessionBusy)
from .kv_source import (WireKvSource, kv_load_stats, load_wire_attachment,
                        wire_source)
from .router import LoadAwareRouter
from .scheduler import (BatchSchedulerOptions, ContinuousBatchScheduler,
                        StepRequest, step_tokens)

__all__ = [
    "BatchSchedulerOptions",
    "ContinuousBatchScheduler",
    "KvPoolOptions",
    "LoadAwareRouter",
    "PagedKvPool",
    "PoolSaturated",
    "SessionBusy",
    "StepRequest",
    "WireKvSource",
    "kv_load_stats",
    "load_wire_attachment",
    "step_tokens",
    "wire_source",
]
