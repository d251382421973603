"""Paged KV-block pool: fixed-size blocks in device memory, free-list
custody, per-session block tables, admission-aware eviction, timer-driven
expiry and copy-on-write prefix sharing.

Port of :mod:`brpc_tpu.serving.kv_pool` (vLLM's PagedAttention block
tables over a fixed block pool).  One pool per decode worker:

  * **Blocks, not sessions, are the allocation unit.**  The backing store
    is a fixed ``(num_blocks, block_tokens × bytes_per_token)`` uint8
    tensor plus a parallel ``(num_blocks, block_tokens)`` int64 per-token
    reduction tensor (the surface the batched decode step gathers from),
    both on the pool's ``device``: the decode worker's card unless the
    caller asks for the CPU.  A session holds an ordered block list (host
    numpy, like the reference's); fragmentation is impossible by
    construction.
  * **Reserve / fill outside the lock / commit.**  ``load_into`` reserves
    the block table under the lock, lets the caller's ``fill`` write token
    rows straight into the reserved blocks without the lock, derives the
    reduction rows on the device, and commits with a re-check.  Reserved
    blocks are off the free list and in no table, so their rows have one
    writer and no reader: the disjoint-row discipline that makes the
    unlocked fill safe.
  * **Copy-on-write prefix sharing** at commit: FULL blocks are keyed by a
    chained ``zlib.crc32`` over the block run (so a key encodes its
    position in the prefix) against a pool-wide index, and sessions whose
    rows share a block-aligned prefix map the same physical blocks under
    a refcount.  The CRC needs the bytes on the host: one device-to-host
    pass over a session's full blocks, taken after the fill and outside
    the lock, counted in ``describe()``.  Every index hit is
    byte-verified on the device (``torch.equal``) before sharing, so a
    collision degrades to no sharing, never to another session's bytes.
  * **Admission-aware eviction**: under pressure the pool evicts parked
    sessions in (band, tenant weight, LRU) order — sheddable bands first,
    lighter tenants first inside a band — and a loader never evicts a
    band more protected than its own.  Victim selection simulates the
    refcount decrements, so a victim whose blocks others share counts
    only the blocks that would free.
  * **Timer-driven expiry**: a TimerThread sweep scheduled while sessions
    exist reclaims idle sessions past ``ttl_s`` with no traffic.
  * **Pins** fence eviction and expiry: the decode scheduler pins every
    session in its step roster.

  * **The host tier** (``host_blocks > 0``): the picker's "evict" becomes
    "demote".  A pressure victim's blocks are copied into a pinned host
    arena (a refcounted shared block spills once) and the session stays
    retrievable.  Any later touch (``get``, ``pin``, ``snapshot``,
    ``write_rows``, the scheduler's roster add) restores it through the
    same reserve / fill-outside-the-lock / commit shape, after checking
    the chained CRC recorded at demote against the host bytes: a corrupt
    host block becomes a typed "corrupt" re-prefill shed, never served
    bytes.  Both copies are stream-ordered ``copy_`` calls between the
    card and pinned memory, followed by a sync.  The spill path registers
    the "spill" plane-health row (timer latch): a failing host arena
    turns pressure back into eviction until the latch lapses.
  * **``write_rows``** overwrites a live session's rows in place, splitting
    a shared block copy-on-write first.

Host syncs per load: the accumulator ``acc`` (one ``.item()``) and the
CRC pass; byte verification adds one per prefix hit.  A demote syncs
once after its device-to-host copy, a restore once after its
host-to-device copy.

Three flags restore the older disciplines for a same-run A/B, each on
by default as in the JAX package: ``serving_kv_prefix_share=False`` gives
every session private blocks (no CRC pass, no index, no CoW),
``serving_kv_concurrent_fill=False`` holds the pool lock through the
fill, and ``serving_kv_spill=False`` evicts on pressure even with a host
arena.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..butil import custody_ledger as _ledger
from ..butil import debug_sync as _dbg
from .. import bvar
from ..butil import flags as _flags
from ..rpc.admission import tenant_weight_of

_flags.define_flag(
    "serving_kv_prefix_share", True,
    "content-hash full KV blocks at load commit so sessions sharing a "
    "block-aligned prefix map the same physical blocks under a refcount "
    "(byte-verified on every hit; divergence or write_rows splits a "
    "private copy).  False gives every session private blocks, with no "
    "CRC pass and no index, for a same-run A/B")

_flags.define_flag(
    "serving_kv_concurrent_fill", True,
    "run load_into's fill outside the pool lock: reserve under the lock, "
    "fill unlocked, commit with a re-check, so concurrent LoadKv fills "
    "proceed in parallel.  False holds the lock through the fill for a "
    "same-run A/B")

_flags.define_flag(
    "serving_kv_spill", True,
    "demote pressure victims to the host arena tier instead of evicting "
    "them (pools built with host_blocks > 0).  False evicts on pressure "
    "for a same-run A/B")

_flags.define_flag(
    "serving_kv_spill_reprobe_s", 0.25,
    "spill plane-health timer latch: how long after a demote/restore IO "
    "failure before the first use re-probes the host tier")


class SessionBusy(RuntimeError):
    """A load hit a session id that is PINNED in the step roster: freeing
    its blocks would hand them to new bytes mid-step, so the reload is
    refused (the RPC layer maps this to a retryable shed).  The same
    refusal fires at COMMIT time when a concurrent loader won the race for
    the session id and its entry got pinned before our re-check."""

    def __init__(self, session: str):
        super().__init__(
            f"session {session!r} is pinned in the decode roster; "
            f"re-prefill must wait for (or cancel) the running decode")
        self.session = session


class PoolSaturated(RuntimeError):
    """A load could not free enough blocks: every candidate session is
    pinned or lives in a band more protected than the requester's.  The
    RPC layer maps this to retryable ``ELIMIT`` + a ``retry_after_ms``
    hint."""

    def __init__(self, needed: int, free: int):
        super().__init__(
            f"kv pool saturated: need {needed} blocks, {free} free and "
            f"no evictable session in an equal-or-less-protected band")
        self.needed = needed
        self.free = free


@dataclass
class KvPoolOptions:
    """Pool geometry + the eviction/expiry policy."""
    bytes_per_token: int
    num_blocks: int = 256
    block_tokens: int = 16
    bands: int = 4                   # priority bands, 0 = most protected
    default_priority: int = 2        # sessions arriving without one
    # host-tier arena size in blocks: 0 disables spill (pressure evicts)
    host_blocks: int = 0
    ttl_s: float = 120.0             # idle-session expiry
    sweep_interval_s: float = 0.0    # 0 = auto: ttl_s / 4, floored
    use_timers: bool = True          # False: tests drive expire_idle()
    tenant_weights: Dict[str, int] = field(default_factory=dict)
    default_tenant_weight: int = 1

    @classmethod
    def from_admission(cls, adm, **kw) -> "KvPoolOptions":
        """Take the eviction order's bands and tenant table from an
        ``rpc.admission.AdmissionOptions``, so queue fairness and memory
        pressure agree on who absorbs overload."""
        kw.setdefault("bands", adm.bands)
        kw.setdefault("default_priority", adm.default_priority)
        kw.setdefault("tenant_weights", dict(adm.tenant_weights))
        kw.setdefault("default_tenant_weight", adm.default_tenant_weight)
        return cls(**kw)

    def effective_sweep_s(self) -> float:
        if self.sweep_interval_s > 0:
            return self.sweep_interval_s
        return max(self.ttl_s / 4.0, 0.05)


class _KvSession:
    """One session's block table (access under the pool lock; the numeric
    fields are immutable after commit, so the scheduler may READ
    blocks/seq_len/acc/last_token from its roster lock-free).  ``pinned``
    is a count (a roster entry and a snapshot view each hold one);
    ``release_pending`` defers a release that arrived while pinned to the
    last unpin.  ``crcs`` is the chained CRC of each full block, computed
    after the fill for the prefix index."""

    __slots__ = ("session", "tenant", "priority", "seq_len", "last_token",
                 "acc", "blocks", "last_used", "pinned",
                 "release_pending", "contiguous", "crcs")

    def __init__(self, session: str, tenant: str, priority: int,
                 seq_len: int, last_token: int, acc: int,
                 blocks: np.ndarray, now: float, crcs: List[int]):
        self.session = session
        self.tenant = tenant
        self.priority = priority
        self.seq_len = seq_len
        self.last_token = last_token
        self.acc = acc
        self.blocks = blocks             # np.int64 (n_blocks,)
        self.last_used = now
        self.pinned = 0
        self.release_pending = False
        self.contiguous = bool((np.diff(blocks) == 1).all())
        self.crcs = crcs


class _SpilledSession:
    """One session parked in the host tier (access under the pool lock).
    ``hblocks`` indexes the host arena; ``crcs`` is the chained crc32 per
    block position, taken over the host copy at demote — the restore
    recomputes it from the host bytes and any divergence aborts into a
    typed re-prefill shed.  ``acc`` survives the round trip."""

    __slots__ = ("session", "tenant", "priority", "seq_len",
                 "last_token", "acc", "hblocks", "crcs", "last_used")

    def __init__(self, session: str, tenant: str, priority: int,
                 seq_len: int, last_token: int, acc: int,
                 hblocks: np.ndarray, crcs: List[int], now: float):
        self.session = session
        self.tenant = tenant
        self.priority = priority
        self.seq_len = seq_len
        self.last_token = last_token
        self.acc = acc
        self.hblocks = hblocks           # np.int64 (n_blocks,)
        self.crcs = crcs
        self.last_used = now


def _runs(pairs):
    """Coalesce (device block, host block) pairs into runs where both
    sides advance by one: ``[(first device block, first host block, n)]``
    — one copy per run."""
    runs: List[list] = []
    for b, h in pairs:
        b, h = int(b), int(h)
        if runs:
            r = runs[-1]
            if b == r[0] + r[2] and h == r[1] + r[2]:
                r[2] += 1
                continue
        runs.append([b, h, 1])
    return runs


class PagedKvPool:
    """The paged KV arena.  Thread-safe; one per decode worker.  Its
    tensors live on ``device``: the card unless the caller asks for the
    CPU (``device="cpu"``).  Device work runs on the calling thread's
    current stream."""

    # cardinality cap for per-tenant eviction counters — the tenant
    # string is untrusted wire input
    MAX_TRACKED_TENANTS = 64

    _GUARDED_BY = {
        "_free": "_lock",
        "_tables": "_lock",
        "_refs": "_lock",
        "_prefix_index": "_lock",
        "_block_hash": "_lock",
        "_recent_evicted": "_lock",
        "_host_free": "_lock",
        "_spilled": "_lock",
        "_host_refs": "_lock",
        "_spill_map": "_lock",
        "_restoring": "_lock",
        "_spill_fault": "_lock",
        "_restore_us": "_lock",
        "_sweep_timer": "_lock",
        "_closed": "_lock",
        "_counters": "_counters_lock",
        "_tenant_labels": "_counters_lock",
    }

    # fablint custody contract.  A pin is owed an unpin; a reservation
    # is owed exactly one of commit / abort / return (the restore path
    # resolves through _finish_restore_locked); the block refcounts free
    # through _free_session_locked (or an inline guarded decrement), the
    # host-tier refcounts through _host_unref_locked.  The methods named
    # here are the protocol implementation and are exempt from the
    # acquire-release rule; everything else that acquires must release
    # on every exit path.
    _CUSTODY = {
        "pin": ("unpin",),
        "pinned": ("unpin",),
        "_reserve_locked": ("_commit_locked", "_abort_fill_locked",
                            "_return_blocks_locked",
                            "_finish_restore_locked"),
        "_refs": ("_free_session_locked", "_return_blocks_locked"),
        "_host_refs": ("_host_unref_locked", "_finish_restore_locked"),
    }

    def __init__(self, options: KvPoolOptions, device=None,
                 now: Optional[Callable[[], float]] = None):
        o = options
        self.options = o
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PagedKvPool: CUDA is not available; pass "
                               "device='cpu' to keep the pool on the host")
        self._now = now or time.monotonic
        self._lock = _dbg.make_lock("PagedKvPool._lock")
        self._counters_lock = _dbg.make_lock("PagedKvPool._counters_lock")
        self._store = torch.zeros(
            (o.num_blocks, o.block_tokens * o.bytes_per_token),
            dtype=torch.uint8, device=self.device)
        self._pos_sums = torch.zeros((o.num_blocks, o.block_tokens),
                                     dtype=torch.int64, device=self.device)
        # the batched decode step's gather surface: a view over the
        # reduction arena, fixed for the pool's lifetime
        self.pos_sums_flat = self._pos_sums.view(-1)
        self._free: List[int] = list(range(o.num_blocks - 1, -1, -1))
        self._tables: Dict[str, _KvSession] = {}
        # per-PHYSICAL-block refcount for every block owned by >= 1
        # session table; reserved blocks mid-fill are in neither _free
        # nor _refs
        self._refs: Dict[int, int] = {}
        # chained-CRC prefix hash -> physical block, and the reverse map
        # for unregistration at free time (a lookup accelerator: every
        # hit is byte-verified before sharing)
        self._prefix_index: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        # recently-evicted ids -> reason, so a late Decode gets a typed
        # "re-prefill" shed instead of an unknown-session error
        self._recent_evicted: Dict[str, str] = {}
        # ---- host tier, all empty when host_blocks == 0.  A host block is
        # written once (at demote, under the lock) and read by at most one
        # restore, which holds its own host refcount for the copy.
        pin = self.device.type == "cuda" and o.host_blocks > 0
        self._host_store = torch.zeros(
            (o.host_blocks, o.block_tokens * o.bytes_per_token),
            dtype=torch.uint8, pin_memory=pin)
        self._host_np = self._host_store.numpy()     # the CRC's view
        self._host_free: List[int] = list(range(o.host_blocks - 1, -1, -1))
        self._spilled: Dict[str, _SpilledSession] = {}
        # per-HOST-block refcount: spilled sessions sharing a prefix share
        # one host copy; an in-flight restore holds an extra count
        self._host_refs: Dict[int, int] = {}
        # live device block -> its host copy, valid while the device
        # block's bytes are unchanged (dropped on free, on an in-place
        # write, and when the host copy frees)
        self._spill_map: Dict[int, int] = {}
        self._restoring: set = set()
        self._spill_fault: Optional[str] = None   # test injection
        self._restore_us: deque = deque(maxlen=512)
        self._spill_health = None
        if o.host_blocks > 0:
            from ..ici.plane_health import register_plane
            self._spill_health = register_plane(
                "spill", retry_s=lambda: float(_flags.get_flag(
                    "serving_kv_spill_reprobe_s")))
        self._sweep_timer = None
        self._closed = False
        self.loads = bvar.Adder("serving_kv_pool_loads")
        self.bytes_in = bvar.Adder("serving_kv_pool_bytes_in")
        self.evictions = bvar.Adder("serving_kv_pool_evictions")
        self.expirations = bvar.Adder("serving_kv_pool_expired")
        self.fill_aborts = bvar.Adder("serving_kv_pool_fill_aborts")
        self.prefix_hits = bvar.Adder("serving_kv_pool_prefix_hits")
        self.commit_races = bvar.Adder("serving_kv_pool_commit_races")
        self.locked_fills = bvar.Adder("serving_kv_pool_locked_fills")
        self.unlocked_fills = bvar.Adder("serving_kv_pool_unlocked_fills")
        # the CRC's device-to-host passes and the bytes they moved
        self.crc_passes = bvar.Adder("serving_kv_pool_crc_d2h_passes")
        self.crc_bytes = bvar.Adder("serving_kv_pool_crc_d2h_bytes")
        self.cow_splits = bvar.Adder("serving_kv_pool_cow_splits")
        # tier truth: demote/restore round trips, restores that failed the
        # CRC (degraded to re-prefill), spilled sessions dropped under
        # host-arena pressure, and the bytes and copy time of each way
        self.demotions = bvar.Adder("serving_kv_pool_demotions")
        self.restores = bvar.Adder("serving_kv_pool_restores")
        self.restore_corrupt = bvar.Adder("serving_kv_pool_restore_corrupt")
        self.host_evictions = bvar.Adder("serving_kv_pool_host_evictions")
        self.demote_bytes = bvar.Adder("serving_kv_pool_demote_bytes")
        self.demote_copy_ns = bvar.Adder("serving_kv_pool_demote_copy_ns")
        self.restore_bytes = bvar.Adder("serving_kv_pool_restore_bytes")
        self.restore_copy_ns = bvar.Adder("serving_kv_pool_restore_copy_ns")
        self._counters: Dict[tuple, bvar.Adder] = {}
        self._tenant_labels: set = set()

    # ---- policy helpers -----------------------------------------------
    def _weight(self, tenant: str) -> int:
        return tenant_weight_of(self.options.tenant_weights,
                                self.options.default_tenant_weight, tenant)

    def _clip_priority(self, priority: Optional[int]) -> int:
        pri = self.options.default_priority if priority is None \
            else priority
        return min(max(pri, 0), self.options.bands - 1)

    def _count(self, what: str, tenant: str) -> None:
        with self._counters_lock:
            if tenant and tenant not in self.options.tenant_weights \
                    and tenant not in self._tenant_labels:
                if len(self._tenant_labels) >= self.MAX_TRACKED_TENANTS:
                    tenant = "~other"
                else:
                    self._tenant_labels.add(tenant)
            key = (what, tenant)
            a = self._counters.get(key)
            if a is None:
                a = self._counters[key] = bvar.Adder(
                    f"serving_kv_{what}[{tenant or 'shared'}]")
        a << 1

    # ---- load / release -----------------------------------------------
    def blocks_for(self, seq_len: int) -> int:
        bt = self.options.block_tokens
        return (seq_len + bt - 1) // bt

    def load(self, session: str, token_rows, *, last_token: int,
             tenant: str = "", priority: Optional[int] = None
             ) -> _KvSession:
        """Page a session's KV in from one token-major uint8 array or
        tensor, shape ``(seq_len, bytes_per_token)``.  A delegation to
        :meth:`load_into` with a row-copy fill.  Raises
        :class:`PoolSaturated` when eviction cannot make room."""
        o = self.options
        rows = torch.as_tensor(np.ascontiguousarray(token_rows, np.uint8)
                               if not isinstance(token_rows, torch.Tensor)
                               else token_rows)
        if rows.dtype != torch.uint8 or rows.dim() != 2 \
                or rows.shape[1] != o.bytes_per_token:
            raise ValueError(
                f"token_rows must be uint8 (seq_len, {o.bytes_per_token}), "
                f"got {rows.dtype} {tuple(rows.shape)}")
        seq_len = rows.shape[0]
        if seq_len <= 0:
            raise ValueError("token_rows must hold at least one token")

        def fill(views: List[torch.Tensor]) -> None:
            off = 0
            for v in views:
                n = v.shape[0]
                v.copy_(rows[off:off + n])
                off += n

        return self.load_into(session, seq_len, fill,
                              last_token=last_token, tenant=tenant,
                              priority=priority)

    def load_into(self, session: str, seq_len: int,
                  fill: Callable[[List[torch.Tensor]], None], *,
                  last_token: int, tenant: str = "",
                  priority: Optional[int] = None) -> _KvSession:
        """Reserve the block table FIRST, then fill blocks IN PLACE.

        ``fill(views)`` receives an ordered list of writable
        ``(n_rows, bytes_per_token)`` uint8 views of the arena, one per
        CONTIGUOUS EXTENT of reserved blocks, together covering exactly
        ``seq_len`` token rows; it must write every row.  It runs OUTSIDE
        the pool lock.  The commit then RE-CHECKS under the lock: a pool
        closed mid-fill raises; a concurrent loader that committed the
        same session id mid-fill is replaced last-commit-wins when
        unpinned, or aborts THIS fill with :class:`SessionBusy` when the
        incumbent got pinned (counted in ``commit_races`` either way).

        If ``fill`` raises, the reservation ABORTS clean: blocks return to
        the free list, no session entry is created, and the exception
        propagates.  After a successful fill the pool derives the
        reduction rows and ``acc`` on the device, zeroes the partial tail
        so no prior tenant's bytes survive, computes the full blocks'
        chained CRCs, dedupes them against the prefix index and commits
        the table.

        ``serving_kv_concurrent_fill=False`` holds the lock from the
        reservation through the commit instead (``fill`` must then not
        call back into this pool), and ``serving_kv_prefix_share=False``
        skips the CRC pass and the dedupe."""
        if seq_len <= 0:
            raise ValueError("seq_len must be >= 1")
        pri = self._clip_priority(priority)
        need = self.blocks_for(seq_len)
        now = self._now()
        share = bool(_flags.get_flag("serving_kv_prefix_share"))
        if not _flags.get_flag("serving_kv_concurrent_fill"):
            with self._lock:
                blocks, deferred_old = self._reserve_locked(session, need,
                                                            pri)
                _ledger.acquire("kv.reserve", (id(self), id(blocks)))
                try:
                    s = self._fill_session(session, tenant, pri, seq_len,
                                           last_token, blocks, now, fill,
                                           share)
                except BaseException:
                    # abort clean (close() cannot race: the lock is held)
                    self._return_blocks_locked(blocks)
                    _ledger.release("kv.reserve", (id(self), id(blocks)))
                    self.fill_aborts << 1
                    raise
                try:
                    self._commit_locked(s, deferred_old)
                finally:
                    _ledger.release("kv.reserve", (id(self), id(blocks)))
            self.locked_fills << 1
        else:
            with self._lock:
                blocks, deferred_old = self._reserve_locked(session, need,
                                                            pri)
            _ledger.acquire("kv.reserve", (id(self), id(blocks)))
            # the fill touches only rows nothing else references;
            # everything between the reserve and the commit sits inside
            # the try, so an abort reaches the reservation from every edge
            try:
                s = self._fill_session(session, tenant, pri, seq_len,
                                       last_token, blocks, now, fill, share)
            except BaseException:
                # abort clean: the reservation never became a session
                with self._lock:
                    self._abort_fill_locked(blocks)
                _ledger.release("kv.reserve", (id(self), id(blocks)))
                self.fill_aborts << 1
                raise
            try:
                with self._lock:
                    self._commit_locked(s, deferred_old)
            finally:
                # a refused commit (SessionBusy, a closed pool) already
                # returned the blocks: custody ends either way
                _ledger.release("kv.reserve", (id(self), id(blocks)))
            self.unlocked_fills << 1
        self.loads << 1
        self.bytes_in << seq_len * self.options.bytes_per_token
        return s

    def _fill_session(self, session, tenant, pri, seq_len, last_token,
                      blocks, now, fill, share: bool) -> "_KvSession":
        """Fill a reservation and build its session: the views, the
        caller's fill, the reduction rows and, when prefixes are shared,
        the full blocks' chained CRCs.  Touches only reserved rows, so it
        runs with or without the pool lock."""
        extents, views = self._extent_views(blocks, seq_len)
        fill(views)
        acc = self._derive_sums(extents, views, seq_len)
        crcs = self._chained_crcs(blocks, seq_len) if share else []
        return _KvSession(session, tenant, pri, seq_len, last_token, acc,
                          blocks, now, crcs)

    def _extent_views(self, blocks: np.ndarray, seq_len: int):
        """Coalesce a reservation into contiguous extents and build the
        writable fill views (one strided pass per extent instead of one
        per 16-token block)."""
        o = self.options
        bt, bpt = o.block_tokens, o.bytes_per_token
        extents = []              # (first_block, n_blocks, n_rows)
        left = seq_len
        b0 = int(blocks[0])
        k = 1
        for i in range(1, len(blocks)):
            b = int(blocks[i])
            if b == b0 + k:
                k += 1
                continue
            rows = min(left, k * bt)
            extents.append((b0, k, rows))
            left -= rows
            b0, k = b, 1
        extents.append((b0, k, min(left, k * bt)))
        views = [self._store[e0:e0 + ek].view(-1, bpt)[:rows]
                 for e0, ek, rows in extents]
        return extents, views

    def _derive_sums(self, extents, views, seq_len: int) -> int:
        """Derive the reduction rows from the filled bytes on the device
        (uint8 rows summed to int64) and zero the partial tail so no prior
        tenant's bytes survive adoption.  Returns the session accumulator:
        the load's one ``.item()``."""
        o = self.options
        bt, bpt = o.block_tokens, o.bytes_per_token
        total = None
        for (e0, ek, rows), v in zip(extents, views):
            sums = v.sum(dim=1, dtype=torch.int64)
            ps = self._pos_sums[e0:e0 + ek].view(-1)
            ps[:rows] = sums
            part = sums.sum()
            total = part if total is None else total + part
            if rows < ek * bt:
                ps[rows:] = 0
                self._store[e0:e0 + ek].view(-1)[rows * bpt:] = 0
        return int(total.item())

    def _chained_crcs(self, blocks: np.ndarray, seq_len: int) -> List[int]:
        """The chained crc32 of each FULL block: the prefix index's keys.
        One device-to-host pass over the full blocks' bytes."""
        full = seq_len // self.options.block_tokens
        if full == 0:
            return []
        idx = torch.as_tensor(blocks[:full], device=self.device)
        host = self._store.index_select(0, idx).cpu().numpy()
        self.crc_passes << 1
        self.crc_bytes << host.nbytes
        crcs, h = [], 0
        for k in range(full):
            h = zlib.crc32(host[k], h)
            crcs.append(h)
        return crcs

    # fablint: lock-held(_lock)
    def _reserve_locked(self, session: str, need: int, pri: int):
        """Allocate ``need`` blocks for ``session``, evicting under
        pressure per the band/weight/LRU policy.  Returns ``(blocks,
        deferred_old)``: the blocks are off the free list and in no table.
        A same-session reload keeps the OLD entry alive as
        ``deferred_old`` whenever the free list alone covers the
        reservation, so an aborted fill leaves the previous KV valid."""
        o = self.options
        if need > o.num_blocks:
            raise PoolSaturated(need, o.num_blocks)
        if self._closed:
            raise RuntimeError("kv pool is closed")
        old = self._tables.get(session)
        deferred_old = None
        if old is not None:
            if old.pinned:
                raise SessionBusy(session)
            if need <= len(self._free):
                deferred_old = old
            else:
                self._free_session_locked(old, "reloaded")
        if need > len(self._free):
            spill = self._spill_usable_locked()
            victims = self._pick_victims_locked(need - len(self._free), pri,
                                                spill=spill)
            if victims is None:
                raise PoolSaturated(need, len(self._free))
            for v in victims:
                # eviction becomes demotion when the host tier is usable;
                # a demote that fails (host arena full, injected fault)
                # falls back to eviction, which frees the same blocks
                if spill and self._demote_session_locked(v):
                    continue
                self._free_session_locked(v, "pressure")
        blocks = np.empty(need, np.int64)
        for k in range(need):
            blocks[k] = self._free.pop()
        return blocks, deferred_old

    # fablint: lock-held(_lock)
    def _abort_fill_locked(self, blocks) -> None:
        """Return an aborted reservation — unless the pool closed
        mid-fill, whose free-list rebuild already reclaimed every block."""
        if not self._closed:
            self._return_blocks_locked(blocks)

    # fablint: lock-held(_lock)
    def _commit_locked(self, s: _KvSession, deferred_old) -> None:
        """Publish a filled reservation: the commit-time re-check.  Order
        matters: the raced/pinned check first (an abort returns the
        ORIGINAL blocks), then prefix dedupe + refcounts, and only then
        the incumbent's free — so a same-content reload shares its
        predecessor's blocks."""
        if self._closed:
            raise RuntimeError("kv pool is closed")
        cur = self._tables.get(s.session)
        if cur is not None:
            if cur is not deferred_old:
                self.commit_races << 1
            if cur.pinned:
                self._return_blocks_locked(s.blocks)
                raise SessionBusy(s.session)
        if _flags.get_flag("serving_kv_prefix_share"):
            self._dedupe_blocks_locked(s)
        for b in s.blocks:
            b = int(b)
            self._refs[b] = self._refs.get(b, 0) + 1
        # fresh bytes supersede any parked host copy of this id
        self._drop_spilled_locked(s.session)
        if cur is not None:
            self._free_session_locked(cur, "reloaded")
        self._tables[s.session] = s
        self._recent_evicted.pop(s.session, None)
        self._schedule_sweep_locked()

    # fablint: lock-held(_lock)
    def _dedupe_blocks_locked(self, s: _KvSession) -> None:
        """Map ``s``'s FULL blocks onto existing physical blocks where a
        byte-identical block-aligned prefix already lives in the pool.
        Sharing stops at the first miss, but registration continues so
        this session donates longer prefixes.  Partial tail blocks never
        share and never register."""
        blocks = s.blocks
        sharing = True
        new_blocks = None
        returned = []
        for k, h in enumerate(s.crcs):
            blk = int(blocks[k])
            if sharing:
                eb = self._prefix_index.get(h)
                if (eb is not None and eb != blk and eb in self._refs
                        and torch.equal(self._store[eb], self._store[blk])):
                    if new_blocks is None:
                        new_blocks = blocks.copy()
                    new_blocks[k] = eb
                    returned.append(blk)
                    self.prefix_hits << 1
                    continue
                sharing = False
            if h not in self._prefix_index:
                self._prefix_index[h] = blk
                self._block_hash[blk] = h
        if new_blocks is not None:
            s.blocks = new_blocks
            s.contiguous = bool((np.diff(new_blocks) == 1).all())
            self._return_blocks_locked(returned)

    # fablint: lock-held(_lock)
    def _unregister_block_locked(self, blk: int) -> None:
        h = self._block_hash.pop(blk, None)
        if h is not None and self._prefix_index.get(h) == blk:
            del self._prefix_index[h]

    # fablint: lock-held(_lock)
    def _pick_victims_locked(self, blocks_needed: int, requester_pri: int,
                             exclude=None, spill: bool = False):
        """Eviction order under pressure: most-sheddable band first,
        lighter tenants before heavier inside a band, LRU inside a class;
        never a band more protected than the requester's.  A victim only
        contributes the blocks that would ACTUALLY free (refcount
        decrements simulated across the victim list).  ``exclude`` fences
        one session out (``write_rows`` never evicts the session it
        writes).

        ``spill=True``: victims will be demoted, so the order prefers a
        whole shared-owner set over an unshared session of the same
        class — the set's blocks spill once for all its owners, and only
        taking it whole frees its shared blocks.  Candidates are grouped
        into shared-block connected components; a group sorts by its most
        protected member's band, shared sets before singletons, then its
        lightest weight, then its oldest LRU.  The free-block simulation
        is the same; grouping only reorders."""
        cands = [s for s in self._tables.values()
                 if not s.pinned and s.priority >= requester_pri
                 and s is not exclude]
        if spill and len(cands) > 1 and self._any_shared_locked():
            parent = list(range(len(cands)))

            def find(x: int) -> int:
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            block_owner: Dict[int, int] = {}
            for i, s in enumerate(cands):
                for b in s.blocks:
                    b = int(b)
                    if self._refs.get(b, 1) > 1:
                        j = block_owner.get(b)
                        if j is None:
                            block_owner[b] = i
                        else:
                            ra, rb = find(i), find(j)
                            if ra != rb:
                                parent[rb] = ra
            comps: Dict[int, List[_KvSession]] = {}
            for i, s in enumerate(cands):
                comps.setdefault(find(i), []).append(s)
            groups = list(comps.values())
            groups.sort(key=lambda g: (
                -min(s.priority for s in g),
                0 if len(g) > 1 else 1,
                min(self._weight(s.tenant) for s in g),
                min(s.last_used for s in g)))
            for g in groups:
                g.sort(key=lambda s: (-s.priority, self._weight(s.tenant),
                                      s.last_used))
            cands = [s for g in groups for s in g]
        else:
            cands.sort(key=lambda s: (-s.priority, self._weight(s.tenant),
                                      s.last_used))
        victims, have = [], 0
        sim: Dict[int, int] = {}
        for s in cands:
            if have >= blocks_needed:
                break
            victims.append(s)
            for b in s.blocks:
                b = int(b)
                taken = sim.get(b, 0)
                sim[b] = taken + 1
                if self._refs.get(b, 1) - taken == 1:
                    have += 1
        return victims if have >= blocks_needed else None

    # fablint: lock-held(_lock)
    def _any_shared_locked(self) -> bool:
        """Does any block have more than one owner?  Every table entry
        holds one ref, so exactly when the entries outnumber the physical
        blocks.  Without a shared block every group of the spill picker is
        a singleton and its order is the plain one, so the grouping pass —
        a walk over every block of every candidate — is skipped."""
        logical = sum(len(s.blocks) for s in self._tables.values())
        return logical > len(self._refs)

    # fablint: lock-held(_lock)
    def _return_blocks_locked(self, blocks) -> None:
        """Put blocks back keeping the free list sorted descending, so
        ``pop()`` hands out ascending runs that coalesce into extents."""
        self._free.extend(int(b) for b in blocks)
        self._free.sort(reverse=True)

    # fablint: lock-held(_lock)
    def _free_session_locked(self, s: _KvSession, reason: str) -> None:
        """Retire a session's table: decrement each block's refcount,
        freeing (and unregistering) only the blocks that reach zero."""
        self._tables.pop(s.session, None)
        dead = []
        for b in s.blocks:
            b = int(b)
            r = self._refs.get(b, 1) - 1
            if r <= 0:
                self._refs.pop(b, None)
                self._unregister_block_locked(b)
                # the block's bytes are about to be rewritten: its host
                # copy no longer mirrors it
                self._spill_map.pop(b, None)
                dead.append(b)
            else:
                self._refs[b] = r
        if dead:
            self._return_blocks_locked(dead)
        if reason in ("pressure", "expired"):
            self._note_gone_locked(s.session, reason)
        if reason == "expired":
            self.expirations << 1
        elif reason == "pressure":
            self.evictions << 1
        elif reason == "spilled":
            # demotion, not death: no recent-evicted entry, no eviction
            self.demotions << 1
        if reason in ("released", "spilled"):
            self._count(reason, s.tenant)
        else:
            self._count(f"evicted_{reason}", s.tenant)

    # fablint: lock-held(_lock)
    def _note_gone_locked(self, session: str, reason: str) -> None:
        """Remember why a session died, for a typed re-prefill shed."""
        self._recent_evicted[session] = reason
        while len(self._recent_evicted) > 256:
            self._recent_evicted.pop(next(iter(self._recent_evicted)))

    # ---- host tier: spill / restore -------------------------------------
    # fablint: lock-held(_lock)
    def _spill_usable_locked(self) -> bool:
        """Demotion is on when the pool has a host arena and the spill
        plane is usable: a latched IO failure turns pressure back into
        eviction until the latch lapses."""
        return (self.options.host_blocks > 0
                and bool(_flags.get_flag("serving_kv_spill"))
                and self._spill_health.usable())

    def _tier_copy(self, runs, to_host: bool) -> int:
        """Copy whole blocks between the device arena and the host arena,
        one stream-ordered ``copy_`` per run, then wait for them: a demote
        reads the host bytes next, a restore drops its host refs next.
        Returns the ns the copies took."""
        t0 = time.perf_counter_ns()
        cuda = self.device.type == "cuda"
        for b, h, n in runs:
            dev, host = self._store[b:b + n], self._host_store[h:h + n]
            if to_host:
                host.copy_(dev, non_blocking=cuda)
            else:
                dev.copy_(host, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter_ns() - t0

    # fablint: lock-held(_lock)
    def _demote_session_locked(self, s: _KvSession) -> bool:
        """Copy ``s``'s blocks into the host arena and retire its device
        table ("spilled": retrievable, not dead).  A device block that
        already has a live host copy reuses it under a refcount — a shared
        block spills once.  False, with the session untouched, when the
        host tier cannot take it (arena full even after reclaiming older
        spilled sessions, or the injected fault): the caller evicts."""
        if self._spill_fault == "demote":
            self._spill_health.mark_down("demote_io")
            return False
        short = self._host_blocks_needed_locked(s) - len(self._host_free)
        if short > 0 and not self._host_reclaim_locked(short, s.priority):
            return False
        # a reclaimed record may have held the host copy of one of s's
        # shared blocks: count again
        if self._host_blocks_needed_locked(s) > len(self._host_free):
            return False
        hblocks = np.empty(len(s.blocks), np.int64)
        fresh = []
        for k, b in enumerate(s.blocks):
            b = int(b)
            hb = self._spill_map.get(b)
            if hb is None:
                hb = self._host_free.pop()
                self._spill_map[b] = hb
                fresh.append((b, hb))
            # fablint: custody-moved(spill-record) the ref lives in the _SpilledSession entry below; _drop_spilled_locked / _host_unref_locked balance it
            self._host_refs[hb] = self._host_refs.get(hb, 0) + 1
            hblocks[k] = hb
        if fresh:
            self.demote_copy_ns << self._tier_copy(_runs(fresh), True)
            self.demote_bytes << len(fresh) * self._host_store.shape[1]
        crcs, chain = [], 0
        for hb in hblocks:
            chain = zlib.crc32(self._host_np[int(hb)], chain)
            crcs.append(chain)
        self._spilled[s.session] = _SpilledSession(
            s.session, s.tenant, s.priority, s.seq_len, s.last_token,
            s.acc, hblocks, crcs, self._now())
        self._free_session_locked(s, "spilled")
        return True

    # fablint: lock-held(_lock)
    def _host_blocks_needed_locked(self, s: _KvSession) -> int:
        """Host blocks a demote of ``s`` must take fresh: its device
        blocks with no live host copy yet."""
        return sum(1 for b in s.blocks if int(b) not in self._spill_map)

    # fablint: lock-held(_lock)
    def _host_reclaim_locked(self, shortage: int, requester_pri: int
                             ) -> bool:
        """Make room in the host arena by dropping the most sheddable
        spilled sessions: the device picker's band/weight/LRU order and
        refcount simulation, fenced to bands no more protected than the
        demoting session's, skipping sessions mid-restore.  The dropped
        sessions die for real (typed "pressure" shed)."""
        cands = [sp for sess, sp in self._spilled.items()
                 if sess not in self._restoring
                 and sp.priority >= requester_pri]
        cands.sort(key=lambda sp: (-sp.priority, self._weight(sp.tenant),
                                   sp.last_used))
        victims, have = [], 0
        sim: Dict[int, int] = {}
        for sp in cands:
            if have >= shortage:
                break
            victims.append(sp)
            for h in sp.hblocks:
                h = int(h)
                taken = sim.get(h, 0)
                sim[h] = taken + 1
                if self._host_refs.get(h, 1) - taken == 1:
                    have += 1
        if have < shortage:
            return False
        for sp in victims:
            self._drop_spilled_locked(sp.session)
            self._note_gone_locked(sp.session, "pressure")
            self.host_evictions << 1
            self._count("evicted_pressure", sp.tenant)
        return True

    # fablint: lock-held(_lock)
    def _drop_spilled_locked(self, session: str) -> None:
        """Retire one spilled record, freeing the host blocks whose
        refcount reaches zero."""
        sp = self._spilled.pop(session, None)
        if sp is not None:
            self._host_unref_locked(sp.hblocks)

    # fablint: lock-held(_lock)
    def _host_unref_locked(self, hblocks) -> None:
        dead = []
        for h in hblocks:
            h = int(h)
            r = self._host_refs.get(h, 1) - 1
            if r <= 0:
                self._host_refs.pop(h, None)
                dead.append(h)
            else:
                self._host_refs[h] = r
        if dead:
            dead_set = set(dead)
            # a freed host block's mapping is stale: a later demote must
            # never alias a recycled host slot
            for b in [b for b, h in self._spill_map.items()
                      if h in dead_set]:
                del self._spill_map[b]
            self._host_free.extend(dead)
            self._host_free.sort(reverse=True)

    def _maybe_restore(self, session: str) -> None:
        """Fault a spilled session back in if (and only if) it is
        host-resident."""
        with self._lock:
            if session in self._tables or session not in self._spilled:
                return
        self._restore(session)

    def _restore(self, session: str) -> Optional[_KvSession]:
        """Bring a spilled session back to the device tier through the
        ``load_into`` shape: device blocks reserved under the lock
        (evicting or demoting others at the session's own priority), the
        CRC check and host-to-device copy outside it (the restore holds
        its own host refs, so a concurrent drop of the record cannot free
        the bytes mid-copy), and a re-checked commit.  A CRC mismatch
        aborts the restore into a typed "corrupt" re-prefill shed.
        Returns None when the restore could not happen (device saturated,
        lost race, IO fault): the caller sheds."""
        o = self.options
        bt, bpt = o.block_tokens, o.bytes_per_token
        t0 = time.perf_counter_ns()
        while True:
            with self._lock:
                s = self._tables.get(session)
                if s is not None:
                    return s
                sp = self._spilled.get(session)
                if sp is None:
                    return None
                if session not in self._restoring:
                    self._restoring.add(session)
                    try:
                        blocks, _ = self._reserve_locked(
                            session, len(sp.hblocks), sp.priority)
                    except PoolSaturated:
                        # no device room even after pressure: the session
                        # stays spilled (a retryable shed)
                        self._restoring.discard(session)
                        return None
                    except BaseException:
                        self._restoring.discard(session)
                        raise
                    for h in sp.hblocks:
                        self._host_refs[int(h)] += 1
                    _ledger.acquire("kv.reserve", (id(self), id(blocks)))
                    fault = self._spill_fault
                    break
            # another thread is restoring this session: wait it out
            time.sleep(0.0005)
        # outside the lock: reserved rows have one writer, and the extra
        # host refs pin the source bytes.  Every outcome resolves through
        # _finish_restore_locked.
        ok = True
        try:
            io_fail = fault == "restore"
            if not io_fail:
                chain = 0
                for k, h in enumerate(sp.hblocks):
                    chain = zlib.crc32(self._host_np[int(h)], chain)
                    if chain != sp.crcs[k]:
                        ok = False
                        break
                if ok:
                    self.restore_copy_ns << self._tier_copy(
                        _runs(zip(blocks, sp.hblocks)), False)
                    self.restore_bytes << len(blocks) * bt * bpt
                    idx = torch.as_tensor(blocks, device=self.device)
                    self._pos_sums[idx] = self._store[idx].view(
                        -1, bt, bpt).sum(dim=2, dtype=torch.int64)
            now = self._now()
        except BaseException:
            with self._lock:
                self._finish_restore_locked(session, sp, blocks, t0,
                                            ok=False, io_fail=False,
                                            now=None, failed=True)
            raise
        with self._lock:
            return self._finish_restore_locked(session, sp, blocks, t0,
                                               ok=ok, io_fail=io_fail,
                                               now=now)

    # fablint: lock-held(_lock)
    def _finish_restore_locked(self, session: str, sp, blocks, t0, *,
                               ok: bool, io_fail: bool,
                               now: Optional[float], failed: bool = False):
        """The restore's one resolution point for both the device
        reservation and its host refs: exactly one of commit, return the
        blocks, or nothing left (the pool closed) happens here."""
        _ledger.release("kv.reserve", (id(self), id(blocks)))
        self._restoring.discard(session)
        if self._closed:
            return None
        self._host_unref_locked(sp.hblocks)
        if failed:
            # the copy raised: the record stays, the reservation returns,
            # the exception propagates
            self._return_blocks_locked(blocks)
            return None
        if io_fail:
            # the transport failed, host bytes presumed intact: keep the
            # record, latch the plane, shed
            self._return_blocks_locked(blocks)
            self._spill_health.mark_down("restore_io")
            return None
        if not ok:
            # the host copy is corrupt: drop it and degrade to a typed
            # re-prefill — corruption is not plane death
            self._return_blocks_locked(blocks)
            if self._spilled.get(session) is sp:
                self._drop_spilled_locked(session)
            self._note_gone_locked(session, "corrupt")
            self.restore_corrupt << 1
            return None
        cur = self._tables.get(session)
        if cur is not None:
            # a re-prefill committed fresh bytes mid-restore: it wins
            self._return_blocks_locked(blocks)
            return cur
        if self._spilled.get(session) is not sp:
            # released, expired or reclaimed mid-copy
            self._return_blocks_locked(blocks)
            return None
        full = sp.seq_len // self.options.block_tokens
        s = _KvSession(session, sp.tenant, sp.priority, sp.seq_len,
                       sp.last_token, sp.acc, blocks, now, sp.crcs[:full])
        # the commit of a load: the first restored co-owner re-registers
        # the shared blocks and later restores map onto them
        self._commit_locked(s, None)
        self.restores << 1
        self._restore_us.append((time.perf_counter_ns() - t0) // 1000)
        return s

    def spill(self, session: str) -> bool:
        """Demote one session to the host tier now.  A pinned session
        refuses with :class:`SessionBusy`; False when the session is
        unknown or the host tier cannot take it."""
        with self._lock:
            s = self._tables.get(session)
            if s is None:
                return False
            if s.pinned:
                raise SessionBusy(session)
            if not self._spill_usable_locked():
                return False
            return self._demote_session_locked(s)

    def spilled_sessions(self) -> List[str]:
        with self._lock:
            return list(self._spilled)

    def inject_spill_fault(self, mode: Optional[str]) -> None:
        """Chaos hook: ``"demote"`` fails every demote, ``"restore"``
        every restore copy (both latch the spill plane down), ``None``
        heals."""
        if mode not in (None, "demote", "restore"):
            raise ValueError(f"unknown spill fault {mode!r}")
        with self._lock:
            self._spill_fault = mode

    def release(self, session: str) -> bool:
        """Session finished: return its blocks.  Idempotent.  A PINNED
        session's release is accepted and deferred to the last unpin; a
        spilled one drops its host record without a restore."""
        with self._lock:
            s = self._tables.get(session)
            if s is None:
                sp = self._spilled.get(session)
                if sp is not None:
                    # an in-flight restore survives the drop (it holds its
                    # own host refs) and its commit re-check aborts
                    self._drop_spilled_locked(session)
                    self._count("released", sp.tenant)
                    return True
                return False
            if s.pinned:
                s.release_pending = True
                return True
            self._free_session_locked(s, "released")
            return True

    # ---- mutation / CoW -------------------------------------------------
    def write_rows(self, session: str, start_token: int, rows) -> int:
        """Overwrite token rows of a live session in place.  A target
        block whose refcount is > 1 is SPLIT first: a private copy is
        allocated (evicting at the session's own priority if the free
        list is empty, never the session being written), the shared
        original keeps its other owners, and the session publishes a NEW
        blocks array.  A private block registered as a prefix donor is
        unregistered before the overwrite, and its host copy unmapped.
        Returns the number of splits.  ``rows``: uint8 ``(n,
        bytes_per_token)``, a numpy array or a tensor."""
        o = self.options
        bt, bpt = o.block_tokens, o.bytes_per_token
        rows = (rows if isinstance(rows, torch.Tensor)
                else torch.as_tensor(np.ascontiguousarray(rows, np.uint8)))
        if rows.dtype != torch.uint8 or rows.dim() != 2 \
                or rows.shape[1] != bpt:
            raise ValueError(f"rows must be uint8 (n, {bpt}), got "
                             f"{rows.dtype} {tuple(rows.shape)}")
        n = rows.shape[0]
        if n <= 0:
            raise ValueError("rows must hold at least one token")
        rows = rows.to(self.device)
        now = self._now()
        self._maybe_restore(session)
        with self._lock:
            s = self._tables.get(session)
            if s is None or s.release_pending:
                raise KeyError(session)
            if start_token < 0 or start_token + n > s.seq_len:
                raise ValueError(
                    f"write [{start_token}, {start_token + n}) outside "
                    f"session of {s.seq_len} tokens")
            first_b = start_token // bt
            last_b = (start_token + n - 1) // bt
            new_blocks = None
            splits = 0
            for k in range(first_b, last_b + 1):
                blk = int(s.blocks[k] if new_blocks is None
                          else new_blocks[k])
                if self._refs.get(blk, 1) > 1 and not self._free:
                    victims = self._pick_victims_locked(1, s.priority,
                                                        exclude=s)
                    if victims is None:
                        raise PoolSaturated(1, 0)
                    for v in victims:
                        self._free_session_locked(v, "pressure")
                # re-checked after the eviction: taking the last co-owner
                # leaves the block private, and splitting it then would
                # strand it off both the free list and every table
                if self._refs.get(blk, 1) > 1:
                    nb = self._free.pop()
                    self._store[nb].copy_(self._store[blk])
                    self._pos_sums[nb].copy_(self._pos_sums[blk])
                    self._refs[blk] -= 1
                    self._refs[nb] = 1
                    if new_blocks is None:
                        new_blocks = s.blocks.copy()
                    new_blocks[k] = nb
                    splits += 1
                    self.cow_splits << 1
                else:
                    self._unregister_block_locked(blk)
                    self._spill_map.pop(blk, None)
            if new_blocks is not None:
                s.blocks = new_blocks
                s.contiguous = bool((np.diff(new_blocks) == 1).all())
            delta = None
            for k in range(first_b, last_b + 1):
                blk = int(s.blocks[k])
                t0 = max(start_token, k * bt)
                t1 = min(start_token + n, (k + 1) * bt)
                src = rows[t0 - start_token:t1 - start_token]
                sl0 = t0 - k * bt
                self._store[blk].view(bt, bpt)[sl0:sl0 + (t1 - t0)].copy_(
                    src)
                new_sums = src.sum(dim=1, dtype=torch.int64)
                ps = self._pos_sums[blk, sl0:sl0 + (t1 - t0)]
                d = new_sums.sum() - ps.sum()
                delta = d if delta is None else delta + d
                ps.copy_(new_sums)
            s.acc += int(delta.item())
            s.last_used = now
            return splits

    # ---- lookup / scheduler surface -----------------------------------
    def get(self, session: str) -> Optional[_KvSession]:
        """The session's table; a host-resident session is restored first
        (the scheduler's roster add and every read surface restore)."""
        with self._lock:
            s = self._tables.get(session)
            if s is not None or session not in self._spilled:
                return s
        return self._restore(session)

    def evicted_reason(self, session: str) -> Optional[str]:
        """Why a recently-missing session is gone ("pressure" /
        "expired" / "corrupt"), so the RPC layer sheds with a re-prefill
        hint.  A session still parked in the host tier answers
        "spilled": its restore failed transiently and a retry may
        succeed without a re-prefill."""
        with self._lock:
            if session in self._spilled:
                return "spilled"
            return self._recent_evicted.get(session)

    def touch(self, session: str) -> None:
        """Keep-alive; reaches the host tier too without restoring."""
        now = self._now()
        with self._lock:
            s = self._tables.get(session)
            if s is not None:
                s.last_used = now
            else:
                sp = self._spilled.get(session)
                if sp is not None:
                    sp.last_used = now

    def pin(self, session: str) -> bool:
        """Fence a session against eviction/expiry (counted — pins nest).
        False when the session is gone, including a deferred release.  A
        host-resident session is restored first: a pin is a read intent."""
        self._maybe_restore(session)
        with self._lock:
            s = self._tables.get(session)
            if s is None or s.release_pending:
                return False
            s.pinned += 1
            _ledger.acquire("kv.pin", (id(self), session))
            return True

    def unpin(self, session: str) -> None:
        now = self._now()
        unbalanced = False
        with self._lock:
            s = self._tables.get(session)
            if s is not None:
                if s.pinned:
                    s.pinned -= 1
                    _ledger.release("kv.pin", (id(self), session),
                                    strict=True)
                else:
                    # an unpin nobody holds: swallowing it silently would
                    # let the NEXT unpin steal a live holder's fence
                    unbalanced = True
                s.last_used = now
                if not s.pinned and s.release_pending:
                    self._free_session_locked(s, "released")
        if unbalanced:
            from ..butil import logging as log
            log.error("kv pool: unbalanced unpin of session %r "
                      "(no pin held) — caller bug", session)

    def materialize(self, session: str) -> Optional[torch.Tensor]:
        """COPY a session's token rows back out, ``(seq_len,
        bytes_per_token)`` on the pool's device."""
        snap = self.snapshot(session)
        return snap[0] if snap is not None else None

    def snapshot(self, session: str, *, view: bool = False):
        """``(rows, seq_len, last_token)`` under ONE lock acquisition.

        ``view=True`` returns ``(rows, seq_len, last_token, is_view)``:
        when the session's blocks are one contiguous ascending extent,
        ``rows`` is a view straight into the arena (no copy) and the
        session is PINNED — the caller MUST ``unpin(session)`` when done
        and MUST NOT write through it (other sessions may share these
        blocks; a tensor cannot be made read-only).  Otherwise the rows
        are a copy, ``is_view=False`` and no pin is owed."""
        o = self.options
        self._maybe_restore(session)
        with self._lock:
            s = self._tables.get(session)
            if s is None or s.release_pending:
                return None
            blocks = s.blocks
            if view and s.contiguous:
                b0 = int(blocks[0])
                rows = self._store[b0:b0 + len(blocks)].view(
                    -1, o.bytes_per_token)[:s.seq_len]
                # fablint: custody-moved(caller) the view pin is owed back through the caller's unpin before any release — the documented view=True contract
                s.pinned += 1
                _ledger.acquire("kv.pin", (id(self), session))
                return rows, s.seq_len, s.last_token, True
            idx = torch.as_tensor(blocks, device=self.device)
            rows = self._store.index_select(0, idx).view(
                -1, o.bytes_per_token)[:s.seq_len]
            if view:
                return rows, s.seq_len, s.last_token, False
            return rows, s.seq_len, s.last_token

    # ---- expiry ---------------------------------------------------------
    # fablint: lock-held(_lock)
    def _schedule_sweep_locked(self) -> None:
        if (not self.options.use_timers or self._closed
                or self._sweep_timer is not None or not self._tables):
            return
        from ..bthread.timer_thread import TimerThread
        self._sweep_timer = TimerThread.instance().schedule_after(
            self._sweep, self.options.effective_sweep_s())

    def _sweep(self) -> None:
        """TimerThread callback: reclaim idle sessions past TTL."""
        with self._lock:
            self._sweep_timer = None
        self.expire_idle()
        with self._lock:
            self._schedule_sweep_locked()

    def expire_idle(self, now: Optional[float] = None) -> int:
        """Reclaim every unpinned session idle past ``ttl_s``.  Returns
        the count (the manual surface for ``use_timers=False``)."""
        now = self._now() if now is None else now
        ttl = self.options.ttl_s
        n = 0
        with self._lock:
            for s in list(self._tables.values()):
                if not s.pinned and now - s.last_used > ttl:
                    self._free_session_locked(s, "expired")
                    n += 1
            for sess, sp in list(self._spilled.items()):
                # spilled sessions age out on the same TTL
                if sess not in self._restoring \
                        and now - sp.last_used > ttl:
                    self._drop_spilled_locked(sess)
                    self._note_gone_locked(sess, "expired")
                    self.expirations << 1
                    self._count("evicted_expired", sp.tenant)
                    n += 1
        return n

    # ---- lifecycle / observability --------------------------------------
    def sessions(self) -> int:
        with self._lock:
            return len(self._tables)

    def session_ids(self) -> List[str]:
        """The device-resident sessions, oldest load first (what a
        scale-down's drain migrates away)."""
        with self._lock:
            return list(self._tables)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            timer = self._sweep_timer
            self._sweep_timer = None
            self._tables.clear()
            self._refs.clear()
            self._prefix_index.clear()
            self._block_hash.clear()
            self._free = list(range(self.options.num_blocks - 1, -1, -1))
            self._spilled.clear()
            self._host_refs.clear()
            self._spill_map.clear()
            self._restoring.clear()
            self._host_free = list(
                range(self.options.host_blocks - 1, -1, -1))
        # custody ends with the pool: the free-list rebuild reclaimed
        # every block, outstanding pins die with the tables
        _ledger.drop_prefix("kv.pin", id(self))
        _ledger.drop_prefix("kv.reserve", id(self))
        if timer is not None:
            from ..bthread.timer_thread import TimerThread
            TimerThread.instance().unschedule(timer)

    def describe(self) -> dict:
        """The /status serving block's pool half (the reference's key
        names where they mean the same thing)."""
        o = self.options
        with self._lock:
            free = len(self._free)
            sessions = len(self._tables)
            pinned = sum(1 for s in self._tables.values() if s.pinned)
            per_tenant: Dict[str, int] = {}
            logical = 0
            for s in self._tables.values():
                key = s.tenant or "shared"
                per_tenant[key] = per_tenant.get(key, 0) + len(s.blocks)
                logical += len(s.blocks)
            shared = sum(1 for r in self._refs.values() if r > 1)
            physical = len(self._refs)
            host_free = len(self._host_free)
            spilled_sessions = len(self._spilled)
            spilled_blocks = len(self._host_refs)
            restore_us = sorted(self._restore_us)
            plane = (self._spill_health.snapshot()
                     if self._spill_health is not None else None)
        with self._counters_lock:
            by_class = {f"{what}[{tenant or 'shared'}]": a.get_value()
                        for (what, tenant), a in self._counters.items()}
        used = o.num_blocks - free
        return {
            "blocks_total": o.num_blocks,
            "blocks_free": free,
            "blocks_used": used,
            "block_tokens": o.block_tokens,
            "utilization": round(used / o.num_blocks, 3),
            "sessions": sessions,
            "pinned": pinned,
            "blocks_by_tenant": per_tenant,
            "loads": self.loads.get_value(),
            "bytes_in": self.bytes_in.get_value(),
            "evictions": self.evictions.get_value(),
            "expired": self.expirations.get_value(),
            "fill_aborts": self.fill_aborts.get_value(),
            "by_tenant": by_class,
            "ttl_s": o.ttl_s,
            "device": str(self.device),
            "prefix": {
                "enabled": bool(_flags.get_flag("serving_kv_prefix_share")),
                "concurrent_fill": bool(_flags.get_flag(
                    "serving_kv_concurrent_fill")),
                "shared_blocks": shared,
                "prefix_hits": self.prefix_hits.get_value(),
                "commit_races": self.commit_races.get_value(),
                "locked_fills": self.locked_fills.get_value(),
                "unlocked_fills": self.unlocked_fills.get_value(),
                "logical_blocks": logical,
                "physical_blocks": physical,
                "sharing_ratio": (round(logical / physical, 3)
                                  if physical else 1.0),
                "crc_d2h_passes": self.crc_passes.get_value(),
                "crc_d2h_bytes": self.crc_bytes.get_value(),
                "cow_splits": self.cow_splits.get_value(),
            },
            "tiers": self._describe_tiers(
                sessions, host_free, spilled_sessions, spilled_blocks,
                restore_us, plane),
        }

    def _describe_tiers(self, resident: int, host_free: int,
                        spilled_sessions: int, spilled_blocks: int,
                        restore_us: List[int], plane) -> dict:
        """Resident against host-parked sessions, the round trips, the
        restore latency, the copies' bytes and time, the spill plane row,
        and the process-wide migration ledger."""
        o = self.options
        out = {
            "enabled": (o.host_blocks > 0
                        and bool(_flags.get_flag("serving_kv_spill"))),
            "host_blocks_total": o.host_blocks,
            "host_blocks_free": host_free,
            "resident_sessions": resident,
            "spilled_sessions": spilled_sessions,
            "spilled_blocks": spilled_blocks,
            "demotions": self.demotions.get_value(),
            "restores": self.restores.get_value(),
            "restore_corrupt": self.restore_corrupt.get_value(),
            "host_evictions": self.host_evictions.get_value(),
            "restore_p50_us": (restore_us[len(restore_us) // 2]
                               if restore_us else 0),
            "demote_bytes": self.demote_bytes.get_value(),
            "demote_copy_us": self.demote_copy_ns.get_value() // 1000,
            "restore_bytes": self.restore_bytes.get_value(),
            "restore_copy_us": self.restore_copy_ns.get_value() // 1000,
        }
        if plane is not None:
            out["plane"] = plane
        from . import migration as _migration
        out["migration"] = {**_migration.migration_stats(),
                            "scope": "process"}
        return out
