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
    through the LALB balancer, and session affinity;
  * :mod:`.migration` — ``migrate_out``: a live session moved to another
    decode worker's pool under a transfer-deadline latch;
  * :mod:`.autoscaler` — ``LoadThresholdAutoscaler``: hysteresis over a
    load signal firing scale-up / drain + scale-down callbacks.

The pool's host tier (spill/restore) and ``write_rows`` live in
:mod:`.kv_pool`.  Not ported yet: the shm and native KV routes.
"""
from .autoscaler import AutoscalerOptions, LoadThresholdAutoscaler
from .kv_pool import (KvPoolOptions, PagedKvPool, PoolSaturated,
                      SessionBusy)
from .kv_source import (WireKvSource, kv_load_stats,
                        load_token_major_attachment, load_wire_attachment,
                        wire_source)
from .migration import migrate_health, migrate_out, migration_stats
from .router import LoadAwareRouter
from .scheduler import (BatchSchedulerOptions, ContinuousBatchScheduler,
                        StepRequest, step_tokens)

__all__ = [
    "AutoscalerOptions",
    "BatchSchedulerOptions",
    "ContinuousBatchScheduler",
    "KvPoolOptions",
    "LoadAwareRouter",
    "LoadThresholdAutoscaler",
    "PagedKvPool",
    "PoolSaturated",
    "SessionBusy",
    "StepRequest",
    "WireKvSource",
    "kv_load_stats",
    "load_token_major_attachment",
    "load_wire_attachment",
    "migrate_health",
    "migrate_out",
    "migration_stats",
    "step_tokens",
    "wire_source",
]
