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

Host syncs per load: the accumulator ``acc`` (one ``.item()``) and the
CRC pass; byte verification adds one per prefix hit.

Not ported yet: the host tier (spill/restore), ``write_rows`` and its CoW
split, and the A/B flags of the reference.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import bvar

BANDS = 4                # priority bands, 0 = most protected
DEFAULT_PRIORITY = 2     # sessions arriving without one


def tenant_weight_of(weights: Dict[str, int], default: int,
                     tenant: str) -> int:
    """THE tenant-weight lookup (floor 1), as the admission queue of the
    reference applies it (brpc_tpu/rpc/admission.py)."""
    return max(1, weights.get(tenant, default))


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
    ttl_s: float = 120.0             # idle-session expiry
    sweep_interval_s: float = 0.0    # 0 = auto: ttl_s / 4, floored
    use_timers: bool = True          # False: tests drive expire_idle()
    tenant_weights: Dict[str, int] = field(default_factory=dict)
    default_tenant_weight: int = 1

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


class PagedKvPool:
    """The paged KV arena.  Thread-safe; one per decode worker.  Its
    tensors live on ``device``: the card unless the caller asks for the
    CPU (``device="cpu"``).  Device work runs on the calling thread's
    current stream."""

    # cardinality cap for per-tenant eviction counters — the tenant
    # string is untrusted wire input
    MAX_TRACKED_TENANTS = 64

    def __init__(self, options: KvPoolOptions, device=None,
                 now: Optional[Callable[[], float]] = None):
        o = options
        self.options = o
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PagedKvPool: CUDA is not available; pass "
                               "device='cpu' to keep the pool on the host")
        self._now = now or time.monotonic
        self._lock = threading.Lock()
        self._counters_lock = threading.Lock()
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
        self._sweep_timer = None
        self._closed = False
        self.loads = bvar.Adder("serving_kv_pool_loads")
        self.bytes_in = bvar.Adder("serving_kv_pool_bytes_in")
        self.evictions = bvar.Adder("serving_kv_pool_evictions")
        self.expirations = bvar.Adder("serving_kv_pool_expired")
        self.fill_aborts = bvar.Adder("serving_kv_pool_fill_aborts")
        self.prefix_hits = bvar.Adder("serving_kv_pool_prefix_hits")
        self.commit_races = bvar.Adder("serving_kv_pool_commit_races")
        self.unlocked_fills = bvar.Adder("serving_kv_pool_unlocked_fills")
        # the CRC's device-to-host passes and the bytes they moved
        self.crc_passes = bvar.Adder("serving_kv_pool_crc_d2h_passes")
        self.crc_bytes = bvar.Adder("serving_kv_pool_crc_d2h_bytes")
        self._counters: Dict[tuple, bvar.Adder] = {}
        self._tenant_labels: set = set()

    # ---- policy helpers -----------------------------------------------
    def _weight(self, tenant: str) -> int:
        return tenant_weight_of(self.options.tenant_weights,
                                self.options.default_tenant_weight, tenant)

    def _clip_priority(self, priority: Optional[int]) -> int:
        pri = DEFAULT_PRIORITY if priority is None else priority
        return min(max(pri, 0), BANDS - 1)

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
        the table."""
        if seq_len <= 0:
            raise ValueError("seq_len must be >= 1")
        pri = self._clip_priority(priority)
        need = self.blocks_for(seq_len)
        now = self._now()
        with self._lock:
            blocks, deferred_old = self._reserve_locked(session, need, pri)
        try:
            extents, views = self._extent_views(blocks, seq_len)
            fill(views)
            acc = self._derive_sums(extents, views, seq_len)
            crcs = self._chained_crcs(blocks, seq_len)
            s = _KvSession(session, tenant, pri, seq_len, last_token, acc,
                           blocks, now, crcs)
        except BaseException:
            # abort clean: the reservation never became a session
            with self._lock:
                self._abort_fill_locked(blocks)
            self.fill_aborts << 1
            raise
        with self._lock:
            self._commit_locked(s, deferred_old)
        self.unlocked_fills << 1
        self.loads << 1
        self.bytes_in << seq_len * self.options.bytes_per_token
        return s

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
            victims = self._pick_victims_locked(need - len(self._free), pri)
            if victims is None:
                raise PoolSaturated(need, len(self._free))
            for v in victims:
                self._free_session_locked(v, "pressure")
        blocks = np.empty(need, np.int64)
        for k in range(need):
            blocks[k] = self._free.pop()
        return blocks, deferred_old

    def _abort_fill_locked(self, blocks) -> None:
        """Return an aborted reservation — unless the pool closed
        mid-fill, whose free-list rebuild already reclaimed every block."""
        if not self._closed:
            self._return_blocks_locked(blocks)

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
        self._dedupe_blocks_locked(s)
        for b in s.blocks:
            b = int(b)
            self._refs[b] = self._refs.get(b, 0) + 1
        if cur is not None:
            self._free_session_locked(cur, "reloaded")
        self._tables[s.session] = s
        self._recent_evicted.pop(s.session, None)
        self._schedule_sweep_locked()

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

    def _unregister_block_locked(self, blk: int) -> None:
        h = self._block_hash.pop(blk, None)
        if h is not None and self._prefix_index.get(h) == blk:
            del self._prefix_index[h]

    def _pick_victims_locked(self, blocks_needed: int, requester_pri: int):
        """Eviction order under pressure: most-sheddable band first,
        lighter tenants before heavier inside a band, LRU inside a class;
        never a band more protected than the requester's.  A victim only
        contributes the blocks that would ACTUALLY free (refcount
        decrements simulated across the victim list)."""
        cands = [s for s in self._tables.values()
                 if not s.pinned and s.priority >= requester_pri]
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

    def _return_blocks_locked(self, blocks) -> None:
        """Put blocks back keeping the free list sorted descending, so
        ``pop()`` hands out ascending runs that coalesce into extents."""
        self._free.extend(int(b) for b in blocks)
        self._free.sort(reverse=True)

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
                dead.append(b)
            else:
                self._refs[b] = r
        if dead:
            self._return_blocks_locked(dead)
        if reason in ("pressure", "expired"):
            self._recent_evicted[s.session] = reason
            while len(self._recent_evicted) > 256:
                self._recent_evicted.pop(next(iter(self._recent_evicted)))
        if reason == "expired":
            self.expirations << 1
        elif reason == "pressure":
            self.evictions << 1
        if reason == "released":
            self._count("released", s.tenant)
        else:
            self._count(f"evicted_{reason}", s.tenant)

    def release(self, session: str) -> bool:
        """Session finished: return its blocks.  Idempotent.  A PINNED
        session's release is accepted and deferred to the last unpin."""
        with self._lock:
            s = self._tables.get(session)
            if s is None:
                return False
            if s.pinned:
                s.release_pending = True
                return True
            self._free_session_locked(s, "released")
            return True

    # ---- lookup / scheduler surface -----------------------------------
    def get(self, session: str) -> Optional[_KvSession]:
        with self._lock:
            return self._tables.get(session)

    def evicted_reason(self, session: str) -> Optional[str]:
        """Why a recently-missing session is gone ("pressure" /
        "expired"), so the RPC layer sheds with a re-prefill hint."""
        with self._lock:
            return self._recent_evicted.get(session)

    def touch(self, session: str) -> None:
        now = self._now()
        with self._lock:
            s = self._tables.get(session)
            if s is not None:
                s.last_used = now

    def pin(self, session: str) -> bool:
        """Fence a session against eviction/expiry (counted — pins nest).
        False when the session is gone, including a deferred release."""
        with self._lock:
            s = self._tables.get(session)
            if s is None or s.release_pending:
                return False
            s.pinned += 1
            return True

    def unpin(self, session: str) -> None:
        now = self._now()
        unbalanced = False
        with self._lock:
            s = self._tables.get(session)
            if s is not None:
                if s.pinned:
                    s.pinned -= 1
                else:
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
        with self._lock:
            s = self._tables.get(session)
            if s is None or s.release_pending:
                return None
            blocks = s.blocks
            if view and s.contiguous:
                b0 = int(blocks[0])
                rows = self._store[b0:b0 + len(blocks)].view(
                    -1, o.bytes_per_token)[:s.seq_len]
                s.pinned += 1
                return rows, s.seq_len, s.last_token, True
            idx = torch.as_tensor(blocks, device=self.device)
            rows = self._store.index_select(0, idx).view(
                -1, o.bytes_per_token)[:s.seq_len]
            if view:
                return rows, s.seq_len, s.last_token, False
            return rows, s.seq_len, s.last_token

    # ---- expiry ---------------------------------------------------------
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
        return n

    # ---- lifecycle / observability --------------------------------------
    def sessions(self) -> int:
        with self._lock:
            return len(self._tables)

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
                "shared_blocks": shared,
                "prefix_hits": self.prefix_hits.get_value(),
                "commit_races": self.commit_races.get_value(),
                "unlocked_fills": self.unlocked_fills.get_value(),
                "logical_blocks": logical,
                "physical_blocks": physical,
                "sharing_ratio": (round(logical / physical, 3)
                                  if physical else 1.0),
                "crc_d2h_passes": self.crc_passes.get_value(),
                "crc_d2h_bytes": self.crc_bytes.get_value(),
            },
        }
