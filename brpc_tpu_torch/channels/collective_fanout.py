"""The compiled collective fan-out, local leg: a Parallel/Partition call as
one scatter → N device-side bodies → one merge.

Port of the local leg of :mod:`brpc_tpu.channels.collective_fanout`.  The
same ``ParallelChannel.call_method`` that fans out N socket RPCs runs the
whole fan-out and its merge on the mesh instead when every sub-channel
targets an ``ici://`` rank whose server registered a **device-side
handler** for the method (``Server.register_collective``), and degrades IN
THE CALL to the per-member RPC loop, with no failure the caller sees, when
a screen fails or a member dies mid-fan-out.

What the JAX package compiles into one ``shard_map`` program over a
submesh of the fan-out's devices, the port runs eagerly, in fan-out order:

  * scatter: MAP_SHARD row i belongs to the fan-out's i-th device.  An
    operand already laid out so (:func:`shard_operand`, or a
    ``ShardedTensor`` over the whole mesh in rank order) is used as it
    is; anything else is placed with ``mesh.device_put`` per row, the
    counterpart of ``jax.device_put`` onto the submesh's sharding (a
    runtime copy, not the device plane).  MAP_REPLICATE hands every body
    one tensor on ``mesh.device(0)``;
  * the body runs once per member, ``handler(row)``, or ``handler(i,
    row)`` with ``takes_index`` — ``i`` the position in the fan-out (JAX's
    ``axis_index("fan")``), not the device id;
  * merge, through :mod:`..ici.collective`: MERGE_SUM a left fold in
    fan-out order (``psum``), MERGE_GATHER a stack (``all_gather``),
    MERGE_CONCAT a concatenation (``all_gather(tiled=True)``); the result
    is one tensor on ``mesh.device(0)``, as JAX's is replicated.
    MERGE_NONE keeps each result with its rank (:class:`FanoutRows`).

Eager PyTorch compiles nothing, so there is no program cache:
``describe()["cache"]`` reads zero programs (a CUDA graph per key is the
compiled half's work, ROADMAP item 11).

The degrade leg is the per-member RPC loop with the same bytes: a row of a
tensor operand rides its sub-call as a DEVICE block owned by the member's
rank (the answer crosses back on ``p2p_copy``); a numpy operand rides as
bytes, as in the JAX package.  :class:`CollectiveMerger` orders the answers
by sub-channel index, never by arrival, and merges them as the compiled
leg does, so both legs give equal results.

Degradation and revival ride the epoch policy of :mod:`..ici.plane_health`:
a failed attempt marks the route down with a reason and the call completes
on the RPC loop; the route re-probes once the registry's epoch moved past
the one it died under (a member's server restarting), or, for a transient
reason (an execution that raised), after ``ici_fanout_reprobe_s``.
Executions are serialized in :class:`FanoutSequencer` order, the total
order every fan-out of the process enters under.

The cross-process leg (announce, member entry runner, pod ownership) waits
for the multi-process fabric: with no pod, a device this process does not
serve screens ``member_down``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..butil import flags as _flags
from ..butil import logging as log
from ..butil.endpoint import SCHEME_ICI
from ..ici import collective as _coll
from ..ici import plane_health as _ph
from ..ici import route as _route
from ..ici.mesh import IciMesh, ShardedTensor
from .collective_lowering import (MERGE_SUM, MERGE_GATHER, MERGE_CONCAT,
                                  MERGE_NONE, MAP_REPLICATE, MAP_SHARD)

_flags.define_flag("ici_fanout_collective", True,
                   "lower eligible Parallel/Partition fan-outs to the "
                   "compiled collective plane (off: always the per-member "
                   "RPC loop)")
_flags.define_flag("ici_fanout_reprobe_s", 5.0,
                   "seconds before a route downed by a TRANSIENT reason "
                   "(exec_failed) re-probes without an epoch move; "
                   "membership reasons stay epoch-gated")

# screen and degrade reasons (route counter labels)
R_MEMBER = "member_down"          # target device not serving the method
R_EXEC = "exec_failed"            # the execution raised mid-fan-out
R_KILLED = "member_killed"        # fault-plan kill fired mid-fan-out
R_TARGET = "target_not_ici"       # a sub-channel is not a fixed ici:// peer
R_MAPPER = "mapper"               # CallMapper not lowerable
R_MERGE = "merge_mismatch"        # client merge mode != registered mode
R_SHAPE = "shape"                 # sharded operand rows != fan-out width
R_UNREGISTERED = "unregistered"   # no device handler for the method

# transient reasons re-probe on a timer; membership reasons wait for the
# epoch to move
_TRANSIENT_REASONS = (R_EXEC,)


class CollectiveMethodDef:
    """One registered device-side body and the merge/mapping contract the
    client's mapper and merger must match."""

    __slots__ = ("name", "handler", "merge", "mapping", "takes_index")

    def __init__(self, name: str, handler: Callable, merge: str,
                 mapping: str, takes_index: bool):
        self.name = name
        self.handler = handler
        self.merge = merge
        self.mapping = mapping
        self.takes_index = takes_index


class CollectiveRegistry:
    """The process's method table and per-device serving marks.

    ``register`` is the capability half of ``Server.register_collective``
    (one body per method, run on every member); ``serve``/``withdraw``
    track which ``ici://k`` ranks have a serving server, the liveness the
    screen consults.  Every transition bumps the epoch, so a degraded route
    sees a member's restart as an epoch move."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._methods: Dict[str, CollectiveMethodDef] = {}
        self._serving: Dict[int, int] = {}      # device -> serve count
        self._epoch = 0

    def register(self, name: str, handler: Callable,
                 merge: str = MERGE_GATHER, mapping: str = MAP_SHARD,
                 takes_index: bool = False) -> None:
        md = CollectiveMethodDef(name, handler, merge, mapping, takes_index)
        with self._lock:
            self._methods[name] = md
            self._epoch += 1

    def method(self, name: str) -> Optional[CollectiveMethodDef]:
        with self._lock:
            return self._methods.get(name)

    def method_names(self) -> List[str]:
        with self._lock:
            return sorted(self._methods)

    def serve(self, device_id: int) -> None:
        """A server on ``ici://device_id`` started.  Counted, not boolean:
        two servers on one rank (a restart's overlap) must not withdraw
        early."""
        with self._lock:
            self._serving[device_id] = self._serving.get(device_id, 0) + 1
            self._epoch += 1

    def withdraw(self, device_id: int) -> None:
        with self._lock:
            n = self._serving.get(device_id, 0)
            if n <= 1:
                self._serving.pop(device_id, None)
            else:
                self._serving[device_id] = n - 1
            self._epoch += 1

    def serving_all(self, device_ids) -> bool:
        """One lock hold for a whole fan-out's liveness check."""
        with self._lock:
            s = self._serving
            return all(s.get(d, 0) > 0 for d in device_ids)

    def local_epoch(self) -> int:
        with self._lock:
            return self._epoch


_registry = CollectiveRegistry()


def registry() -> CollectiveRegistry:
    return _registry


def register_device_handler(name: str, handler: Callable,
                            merge: str = MERGE_GATHER,
                            mapping: str = MAP_SHARD,
                            takes_index: bool = False) -> None:
    """Module-level registration (tests, handler libraries); servers use
    ``Server.register_collective``, which also marks their rank."""
    _registry.register(name, handler, merge, mapping, takes_index)


# ---------------------------------------------------------------------------
# The sequencer: the total order every fan-out enters under.
# ---------------------------------------------------------------------------

class SlotTimeout(RuntimeError):
    """The call's deadline passed before its slot came up: contention, not
    a route failure; the call falls back without degrading the route."""


class CollectiveExecError(RuntimeError):
    """An execution-stage failure, carrying the route counter's reason."""

    def __init__(self, reason: str, text: str):
        super().__init__(text)
        self.reason = reason


class FanoutSequencer:
    """A dense total order over this process's fan-out executions: a seq
    is assigned at submit and executions are admitted strictly in seq
    order, one at a time."""

    def __init__(self) -> None:
        self._cv = threading.Condition(threading.Lock())
        self._next_assign = 0
        self._next_exec = 0
        self._aborted: set = set()

    def submit(self) -> int:
        with self._cv:
            seq = self._next_assign
            self._next_assign += 1
            return seq

    def _advance_aborted_locked(self) -> None:
        while self._next_exec in self._aborted:
            self._aborted.discard(self._next_exec)
            self._next_exec += 1
            self._cv.notify_all()

    def run(self, seq: int, fn: Callable[[], Any],
            deadline: Optional[float] = None) -> Any:
        """Run ``fn`` at its slot (after every earlier slot retired).  The
        slot always retires: a raising entry must not wedge later
        fan-outs, and a caller that gives up waiting (``deadline``, in
        ``time.monotonic`` terms) aborts its slot so successors move past
        it (SlotTimeout)."""
        with self._cv:
            while True:
                self._advance_aborted_locked()
                if self._next_exec == seq:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    self._aborted.add(seq)
                    self._cv.notify_all()
                    raise SlotTimeout(f"fan-out slot {seq} not reached "
                                      f"before the call deadline")
                self._cv.wait(0.2)
        try:
            return fn()
        finally:
            with self._cv:
                self._next_exec = seq + 1
                self._advance_aborted_locked()
                self._cv.notify_all()

    def describe(self) -> dict:
        with self._cv:
            return {"assigned": self._next_assign,
                    "executed": self._next_exec}


# ---------------------------------------------------------------------------
# Layout: rows owned by the fan-out's ranks, in fan-out order.
# ---------------------------------------------------------------------------

class FanoutRows:
    """An ``(n, *chunk)`` value held one row per fan-out member: row i is a
    tensor owned by ``devices[i]`` (the layout of a JAX array sharded over
    the fan-out's submesh).  The mesh-wide :class:`ShardedTensor` is the
    special case ``devices == (0, ..., n-1)``."""

    __slots__ = ("rows", "devices", "mesh")

    def __init__(self, rows, devices, mesh: IciMesh):
        rows = list(rows)
        if len(rows) != len(devices):
            raise ValueError(f"FanoutRows: {len(rows)} rows for "
                             f"{len(devices)} devices")
        for i, (row, dev) in enumerate(zip(rows, devices)):
            if mesh.rank_of(row) != dev:
                raise ValueError(f"FanoutRows: row {i} is owned by rank "
                                 f"{mesh.rank_of(row)}, not {dev}")
        self.rows: List[torch.Tensor] = rows
        self.devices = tuple(devices)
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self.rows),) + tuple(self.rows[0].shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.rows[0].dtype

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.rows[i]

    def stack(self) -> torch.Tensor:
        """One ``(n, *chunk)`` tensor on ``mesh.device(0)``."""
        return _coll.gather(self.rows, self.mesh.device(0))


def _placed_rows(operand, devices, mesh: IciMesh) -> Optional[List]:
    """The operand's rows when it is already laid out over ``devices`` in
    order (row i owned by devices[i]), else None."""
    if isinstance(operand, FanoutRows):
        if operand.devices == tuple(devices) and operand.mesh is mesh:
            return operand.rows
        return None
    if isinstance(operand, ShardedTensor):
        if operand.mesh is mesh and tuple(devices) == tuple(
                range(mesh.size)):
            return operand.rows
    return None


def _as_tensor(operand) -> torch.Tensor:
    if isinstance(operand, (FanoutRows, ShardedTensor)):
        return operand.stack()
    return torch.as_tensor(np.asarray(operand)) \
        if not isinstance(operand, torch.Tensor) else operand


def shard_operand(devices, operand, mapping: str = MAP_SHARD,
                  mesh: Optional[IciMesh] = None):
    """Lay an operand out exactly as the compiled leg takes it, so the
    per-call placement copy disappears: for MAP_SHARD a
    :class:`FanoutRows`, row i on ``devices[i]``; otherwise one tensor on
    ``mesh.device(0)``.  A pipeline holding mesh-resident data hands the
    plane its rows already scattered."""
    mesh = mesh or IciMesh.default()
    devices = tuple(devices)
    if mapping != MAP_SHARD:
        return _as_tensor(operand).to(mesh.device(0))
    placed = _placed_rows(operand, devices, mesh)
    if placed is not None:
        return FanoutRows(placed, devices, mesh)
    x = _as_tensor(operand)
    if x.dim() == 0 or x.shape[0] != len(devices):
        raise ValueError(f"shard_operand: expected ({len(devices)}, ...), "
                         f"got {tuple(x.shape)}")
    return FanoutRows([mesh.device_put(x[i], d)
                       for i, d in enumerate(devices)], devices, mesh)


# ---------------------------------------------------------------------------
# The per-member loop's halves of the same semantics.
# ---------------------------------------------------------------------------

def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _device_block(t: torch.Tensor):
    """``t``'s bytes as an IOBuf holding one DEVICE block (a zero-copy
    view of a contiguous tensor, so its rank is the tensor's)."""
    from ..butil.iobuf import IOBuf
    buf = IOBuf()
    buf.append_device_array(t.contiguous().view(torch.uint8).reshape(-1))
    return buf


def _host_bytes(t) -> bytes:
    return _as_tensor(t).contiguous().cpu().numpy().tobytes()


class ShardingCallMapper:
    """The per-member loop's half of MAP_SHARD: row ``i`` of
    ``cntl.fanout_operand`` is sub-call ``i``'s request attachment.  A
    tensor operand's row rides as a DEVICE block owned by the member's
    rank (placed as the compiled leg places it); a numpy operand's row
    rides as bytes."""

    collective_mapping = MAP_SHARD

    def map_fanout(self, index: int, method_full_name: str, request: Any,
                   parent_cntl) -> "SubCall":
        from .parallel_channel import SubCall
        op = parent_cntl.fanout_operand
        devices = parent_cntl.__dict__.get("_fanout_devices")
        if isinstance(op, np.ndarray) or devices is None:
            # bytes: a numpy operand, or members that are no ici:// ranks
            return SubCall(request, attachment=_host_bytes(op[index]))
        rows = parent_cntl.__dict__.get("_fanout_rows")
        if rows is None:
            rows = shard_operand(devices, op, MAP_SHARD,
                                 IciMesh.default()).rows
            parent_cntl.__dict__["_fanout_rows"] = rows
        return SubCall(request, attachment=_device_block(rows[index]))

    def map(self, index: int, method_full_name: str, request: Any):
        from .parallel_channel import SubCall
        return SubCall(request)


class ReplicateFanoutMapper:
    """MAP_REPLICATE on the per-member loop: the whole operand rides every
    sub-call.  A tensor operand rides as a DEVICE block owned by the
    fan-out's first rank (copied there once a fan-out when no rank owns
    it); a numpy operand as bytes, serialized once a fan-out."""

    collective_mapping = MAP_REPLICATE

    def map_fanout(self, index: int, method_full_name: str, request: Any,
                   parent_cntl) -> "SubCall":
        from .parallel_channel import SubCall
        op = parent_cntl.fanout_operand
        devices = parent_cntl.__dict__.get("_fanout_devices")
        if isinstance(op, np.ndarray) or devices is None:
            blob = parent_cntl.__dict__.get("_fanout_replica_bytes")
            if blob is None:
                blob = parent_cntl.__dict__["_fanout_replica_bytes"] = \
                    _host_bytes(op)
            return SubCall(request, attachment=blob)
        replica = parent_cntl.__dict__.get("_fanout_replica")
        if replica is None:
            mesh = IciMesh.default()
            t = _as_tensor(op)
            if mesh.rank_of(t) < 0:
                t = mesh.device_put(t.to(mesh.device(0)), devices[0])
            replica = parent_cntl.__dict__["_fanout_replica"] = t
        return SubCall(request, attachment=_device_block(replica))

    def map(self, index: int, method_full_name: str, request: Any):
        from .parallel_channel import SubCall
        return SubCall(request)


class CollectiveMerger:
    """A ResponseMerger whose merge is the compiled leg's, on the RPC
    loop: each sub-response attachment (a DEVICE block or bytes) is read
    as ``dtype`` of ``shard_shape``, the parts are ordered by sub-channel
    INDEX (never arrival) and stacked (gather; also the none merge, as in
    the JAX package), folded (sum) or concatenated (concat) on
    ``mesh.device(0)`` into ``cntl.fanout_result``.  One instance may
    serve every sub-channel: per-call state lives on the parent
    controller."""

    def __init__(self, merge: str = MERGE_GATHER, dtype: str = "uint8",
                 shard_shape: Optional[Tuple[int, ...]] = None):
        self.collective_merge = merge
        self.dtype = dtype
        self.shard_shape = shard_shape

    def merge_sub(self, parent_cntl, index: int, sub_cntl,
                  response: Any) -> int:
        parts = parent_cntl.__dict__.setdefault("_fanout_parts", {})
        parts[index] = sub_cntl._peek_response_attachment()
        return 0                         # MERGED

    def _part(self, att) -> torch.Tensor:
        dt = _torch_dtype(self.dtype)
        refs = att.device_refs() if att is not None else []
        if att is not None and len(refs) == 1 and refs[0].length == len(att):
            r = refs[0]
            t = r.block.data[r.offset:r.offset + r.length].view(dt)
        else:
            data = att.to_bytes() if att is not None else b""
            t = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy()
                                 ).view(dt)
        if self.shard_shape is not None:
            t = t.reshape(self.shard_shape)
        return t

    def finalize_fanout(self, parent_cntl) -> None:
        parts = parent_cntl.__dict__.get("_fanout_parts")
        if not parts:
            return
        dev = IciMesh.default().device(0)
        arrs = [self._part(parts[i]) for i in sorted(parts)]
        if self.collective_merge == MERGE_SUM:
            out = _coll.fold(arrs, dev)
        elif self.collective_merge == MERGE_CONCAT:
            out = torch.cat([a.to(dev) for a in arrs], dim=0)
        else:
            out = _coll.gather(arrs, dev)
        parent_cntl.fanout_result = out


# ---------------------------------------------------------------------------
# The plane.
# ---------------------------------------------------------------------------

class _Lowering:
    """One screened fan-out: everything ``execute`` needs."""
    __slots__ = ("method", "md", "devices", "operand", "mapping")

    def __init__(self, method, md, devices, operand, mapping):
        self.method = method
        self.md = md
        self.devices = devices
        self.operand = operand
        self.mapping = mapping


class CollectiveFanoutPlane:
    """The process's fan-out plane: the screen, the degrade/revive state
    machine and the local leg."""

    _instance: Optional["CollectiveFanoutPlane"] = None
    _ilock = threading.Lock()

    def __init__(self) -> None:
        self._health = _ph.register_plane(
            "collective", threading.Lock(),
            epoch_fn=_registry.local_epoch,
            transient_reasons=_TRANSIENT_REASONS,
            reprobe_s=lambda: _flags.get_flag("ici_fanout_reprobe_s"),
            events=self._on_event)
        self.sequencer = FanoutSequencer()

    @classmethod
    def instance(cls) -> "CollectiveFanoutPlane":
        # every ParallelChannel operand call passes here: the published
        # instance never changes, so the read needs no lock
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._ilock:
            if cls._instance is None:
                cls._instance = CollectiveFanoutPlane()
            return cls._instance

    # ---- health ----------------------------------------------------------
    @staticmethod
    def _on_event(event: str, reason: str) -> None:
        _route.record_collective(event, reason)
        if event == "degraded":
            log.warning("collective fan-out route DOWN (%s); per-member RPC "
                        "loop until the epoch moves%s", reason,
                        " or the reprobe window elapses"
                        if reason in _TRANSIENT_REASONS else "")
        else:
            log.info("collective fan-out route REVIVED (was %s)", reason)

    def mark_down(self, reason: str) -> None:
        self._health.mark_down(reason)

    def route_usable(self) -> bool:
        return self._health.usable()

    def health(self) -> dict:
        snap = self._health.snapshot()
        return {"down": snap["state"] != _ph.UP,
                "reason": snap["reason"],
                "down_epoch": snap["down_epoch"]}

    # ---- screen ------------------------------------------------------------
    def screen(self, subs, method_full_name: str, cntl, pchan=None) \
            -> Tuple[Optional[_Lowering], str]:
        """``(lowering, "")`` when the fan-out lowers, ``(None, reason)``
        otherwise.  Cheap first: a plain fan-out pays one dict lookup.
        The sub → device resolution caches on the channel while every sub
        is a fixed-endpoint channel, keyed by the endpoint objects'
        identity (a sub re-init()ed to another rank replaces its
        endpoint and so invalidates the entry)."""
        operand = cntl.__dict__.get("fanout_operand")
        if operand is None:
            return None, "no_operand"
        if not _flags.get_flag("ici_fanout_collective"):
            return None, "disabled"
        md = _registry.method(method_full_name)
        if md is None:
            return None, R_UNREGISTERED
        cache = pchan.__dict__.setdefault("_cf_screen", {}) \
            if pchan is not None else None
        cached = cache.get(method_full_name) if cache is not None else None
        eps = tuple(getattr(c, "_endpoint", None) for c, _m, _g in subs)
        if cached is not None and cached[0] is not None \
                and len(cached[0]) == len(eps) \
                and all(a is b for a, b in zip(cached[0], eps)):
            devices, mapping, merge_mode = cached[1], cached[2], cached[3]
        else:
            devices_l: List[int] = []
            mapping = None
            merge_mode = None
            cacheable = pchan is not None
            for chan, mapper, merger in subs:
                if getattr(chan, "_endpoint", None) is None:
                    cacheable = False     # balanced: membership can move
                dev = _sub_device(chan)
                if dev is None:
                    return None, R_TARGET
                devices_l.append(dev)
                m = getattr(mapper, "collective_mapping", None)
                if m is None or getattr(mapper, "map_fanout", None) is None:
                    # a degrade must carry the operand on the RPC loop too
                    return None, R_MAPPER
                if mapping is not None and m != mapping:
                    return None, R_MAPPER
                mapping = m
                mm = getattr(merger, "collective_merge", None)
                if mm is None:
                    return None, R_MERGE
                if merge_mode is not None and mm != merge_mode:
                    return None, R_MERGE
                merge_mode = mm
            if len(set(devices_l)) != len(devices_l):
                return None, R_TARGET
            devices = tuple(devices_l)
            if cacheable and cache is not None:
                cache[method_full_name] = (eps, devices, mapping,
                                           merge_mode)
        if merge_mode != md.merge:
            return None, R_MERGE
        if mapping != md.mapping:
            return None, R_MAPPER
        if not hasattr(operand, "shape") or not hasattr(operand, "dtype"):
            return None, R_SHAPE
        if mapping == MAP_SHARD:
            try:
                rows = operand.shape[0]
            except Exception:
                return None, R_SHAPE
            if rows != len(devices):
                return None, R_SHAPE
        mesh = IciMesh.default()
        if any(d >= mesh.size for d in devices):
            return None, R_TARGET
        # every rank of the mesh is this process's; with no pod, a rank
        # no server here serves is a member that is down
        if not _registry.serving_all(devices):
            return None, R_MEMBER
        if not self.route_usable():
            return None, "route_down"
        return _Lowering(method_full_name, md, devices, operand,
                         mapping), ""

    def cache_stats(self) -> dict:
        return {"programs": 0, "building": 0}

    # ---- execution -----------------------------------------------------------
    def execute(self, low: _Lowering, cntl) -> Any:
        """Run one screened fan-out at its slot in the total order.
        Raises on any failure; the caller marks the route down and
        completes the call on the per-member loop."""
        seq = self.sequencer.submit()
        deadline = None
        if cntl.timeout_ms is not None and cntl.timeout_ms > 0:
            # the slot wait is bounded by the call's deadline
            deadline = time.monotonic() + cntl.timeout_ms / 1000.0

        def entry():
            from ..rpc import fault_injection as _fi
            plan = _fi.fabric_active()
            if plan is not None:
                refusal = plan.on_collective_execute(low.devices)
                if refusal is not None:
                    raise CollectiveExecError(R_KILLED, refusal)
            return self._enter(low, cntl)

        return self.sequencer.run(seq, entry, deadline=deadline)

    def _enter(self, low: _Lowering, cntl) -> Any:
        try:
            out = self._run_local(low)
            last = out.rows[-1] if isinstance(out, FanoutRows) else out
            if last.is_cuda:
                # the JAX leg's block_until_ready: a failure surfaces in
                # this call, not in the caller's next op
                torch.cuda.current_stream(last.device).synchronize()
        except CollectiveExecError:
            raise
        except Exception as e:
            raise CollectiveExecError(R_EXEC, f"{type(e).__name__}: {e}")
        cntl.fanout_result = out
        return out

    def _run_local(self, low: _Lowering):
        """Scatter, one body per member in fan-out order, the merge."""
        mesh = IciMesh.default()
        md = low.md
        if low.mapping == MAP_SHARD:
            args = shard_operand(low.devices, low.operand, MAP_SHARD,
                                 mesh).rows
        else:
            rep = shard_operand(low.devices, low.operand, MAP_REPLICATE,
                                mesh)
            args = [rep] * len(low.devices)
        results = []
        for i, (dev, arg) in enumerate(zip(low.devices, args)):
            r = md.handler(i, arg) if md.takes_index else md.handler(arg)
            results.append(torch.as_tensor(r, device=mesh.device(dev)))
        dev0 = mesh.device(0)
        if md.merge == MERGE_SUM:
            return _coll.fold(results, dev0)
        if md.merge == MERGE_GATHER:
            return _coll.gather(results, dev0)
        if md.merge == MERGE_CONCAT:
            return torch.cat([r.to(dev0) for r in results], dim=0)
        # MERGE_NONE: each result stays with its rank; a result that is
        # the operand's own row is copied, never claimed
        held = {a.untyped_storage().data_ptr() for a in args}
        rows = []
        for dev, r in zip(low.devices, results):
            if r.untyped_storage().data_ptr() in held:
                r = r.clone()
            rows.append(mesh.own(r, dev))
        return FanoutRows(rows, low.devices, mesh)


# ---------------------------------------------------------------------------
# Screen helpers.
# ---------------------------------------------------------------------------

def _sub_device(chan) -> Optional[int]:
    """The fixed ``ici://k`` rank a sub-channel targets, or None.  A
    PartitionChannel's sub (a balancer over one partition) resolves when
    exactly one server backs the partition."""
    ep = getattr(chan, "_endpoint", None)
    if ep is None:
        lb = getattr(chan, "_lb", None)
        if lb is None:
            return None
        try:
            entries = lb.servers()
        except Exception:
            return None
        if len(entries) != 1:
            return None
        ep = entries[0].endpoint
    if getattr(ep, "scheme", None) != SCHEME_ICI \
            or len(getattr(ep, "coords", ())) != 1:
        return None
    return ep.device_id


def note_loop_devices(subs, cntl) -> None:
    """Before the per-member loop of an operand call: record the members'
    ranks (when every sub-channel is a distinct ``ici://`` rank), where
    the fan-out mappers place a tensor operand's rows."""
    devices = tuple(_sub_device(chan) for chan, _m, _g in subs)
    if None not in devices and len(set(devices)) == len(devices):
        cntl.__dict__["_fanout_devices"] = devices


# ---------------------------------------------------------------------------
# The ParallelChannel hook.
# ---------------------------------------------------------------------------

def _try_execute(plane: CollectiveFanoutPlane, low: _Lowering,
                 cntl) -> bool:
    """Run one screened fan-out; True on success (route stamped, result
    in ``cntl.fanout_result``).  On a failure the route's health and
    counters move, the call's remaining deadline loses the time the
    attempt took, and False sends the caller to the per-member loop."""
    t0 = time.monotonic_ns()
    try:
        plane.execute(low, cntl)
    except SlotTimeout as e:
        # contention, not a route failure: this call falls back
        _route.record_collective("slot_timeout")
        log.warning("collective fan-out slot timeout (%s); this call "
                    "rides per-member RPCs", e)
    except CollectiveExecError as e:
        plane.mark_down(e.reason)
        log.warning("collective fan-out degraded in-call (%s: %s); "
                    "completing on per-member RPCs", e.reason, e)
    except Exception as e:               # never fail the call
        plane.mark_down(R_EXEC)
        log.error("collective fan-out unexpected failure (%s); "
                  "completing on per-member RPCs", e, exc_info=True)
    else:
        _route.record_collective("selected")
        cntl.fanout_route = "collective"
        cntl.latency_us = (time.monotonic_ns() - t0) // 1000
        return True
    cntl.fanout_route = "rpc"
    if cntl.timeout_ms is not None and cntl.timeout_ms > 0:
        spent_ms = (time.monotonic_ns() - t0) // 1_000_000
        cntl.timeout_ms = max(int(cntl.timeout_ms - spent_ms), 1)
    return False


def maybe_call(pchan, method_full_name: str, cntl, request,
               response, done) -> bool:
    """Try the compiled route for one fan-out.  True: the plane handled
    the call (result in ``cntl.fanout_result``, route stamped; an async
    caller's ``done`` fires from a tasklet, which also runs the
    execution).  False: the caller runs the per-member loop; a failed
    attempt already marked the route down and counted its reason, so the
    degrade is invisible to the caller."""
    if cntl.__dict__.get("_fanout_no_compiled"):
        return False                     # the async fallback's re-entry
    plane = CollectiveFanoutPlane.instance()
    low, reason = plane.screen(pchan._subs, method_full_name, cntl,
                               pchan=pchan)
    if low is None:
        if reason not in ("no_operand", "disabled", "route_down"):
            _route.record_collective("ineligible", reason)
        if cntl.__dict__.get("fanout_operand") is not None:
            cntl.fanout_route = "rpc"
        return False
    if done is not None:
        from ..bthread import scheduler

        def _bg():
            if _try_execute(plane, low, cntl):
                cntl.response = response
                done(cntl)
            else:
                cntl.__dict__["_fanout_no_compiled"] = True
                pchan.call_method(method_full_name, cntl, request,
                                  response, done=done)

        scheduler.start_background(_bg, name="collective_fanout_call")
        return True
    if not _try_execute(plane, low, cntl):
        return False
    cntl.response = response
    return True


def describe() -> dict:
    """The /ici page's collective fan-out block."""
    plane = CollectiveFanoutPlane.instance()
    return {
        "health": plane.health(),
        "sequencer": plane.sequencer.describe(),
        "cache": plane.cache_stats(),
        "registered_methods": _registry.method_names(),
    }
