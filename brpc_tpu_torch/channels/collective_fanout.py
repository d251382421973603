"""The compiled collective fan-out: a Parallel/Partition call as one
scatter → N device-side bodies → one merge, in one process or across the
pod's processes.

Port of :mod:`brpc_tpu.channels.collective_fanout`.  The same
``ParallelChannel.call_method`` that fans out N socket RPCs runs the whole
fan-out and its merge on the mesh instead when every sub-channel targets
an ``ici://`` rank whose server registered a **device-side handler** for
the method (``Server.register_collective``), and degrades IN THE CALL to
the per-member RPC loop, with no failure the caller sees, when a screen
fails or a member dies mid-fan-out.

What the JAX package compiles into one ``shard_map`` program over a
submesh of the fan-out's devices, the port runs eagerly, in fan-out order.
Two legs, split by where the fan-out's ranks live:

**Local** — every rank is this process's:

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

**Cross-process** — some ranks are served by other members of the pod
(:mod:`..ici.pod`; the screen finds each rank's owner, an UP member
serving it, not draining it and advertising the method in ``coll``).
Every member must run the same fan-out in the same order, so the client
announces it (frame 21: method, seq, devices, mapping, merge, shape,
dtype, uuid, cpid) to every remote owner over the fabric's control
channel; each member validates it, PARKS the entry and accepts (22) or
refuses (23); only once every member accepted does the client commit
(24, in sorted pid order), and a member enters in commit order through one
entry runner that takes a slot in its own process's
:class:`FanoutSequencer`.  Two-phase, because a member that entered on its
accept alone would run a fan-out a degraded client never collects.  The
JAX program then broadcasts the request from the client's row by
``psum`` and merges by a collective; the port moves those bytes with the
device leg of :mod:`..ici.ipc_pull` instead, ``p2p_copy`` the only byte
mover:

  * scatter: the client exports the operand's allocation ONCE, and the
    announce carries one export per fan-out index, each with its row's
    offset (an IPC handle names a whole allocation); each member pulls
    every row it owns with one ``p2p_copy`` launch (the whole operand
    under MAP_REPLICATE), whatever its size — this is the collective's
    counterpart, not a socket payload, so ``ici_device_plane_threshold``
    does not apply.  The client holds the pin until every member has
    pulled;
  * bodies: member ``idx`` runs its body on row ``idx`` (``takes_index``
    passes ``idx``), the client on its own rows in place;
  * gather: each member exports its results (COLL_RESULT, 41, also its
    word that its pulls are done) and the client pulls each with one
    launch, then merges exactly as the local leg does; the members' pins
    release at the client's COLL_RELEASE (43), as a kind-4 send releases
    at PULLED.  MERGE_NONE keeps each row with its rank: the client's
    :class:`FanoutRows` holds its own rows, reading a remote one raises
    with its owner's pid, and the members throw theirs away (as the JAX
    members do the merged value).

Any failure — a refused export, open or launch, a member's failure
(COLL_FAIL, 42) or silence past ``ici_fanout_xproc_timeout_s``, its
death — raises :class:`CollectiveExecError` and the call degrades in-call
with the reason counted; a member that dies after accepting hangs neither
the client nor another member's runner.  The leg runs where
``device_plane.xproc_compiled_ok()`` says so (a CUDA mesh; on a CPU mesh
only when forced, through shared-memory segments and the copy's plain
version); elsewhere the screen declines it (``xproc_uncompiled``), and a
member that cannot run it refuses the announce.

KNOWN LIMIT (as in the JAX package): the sequencer totally orders ONE
process's entries, and the announce totally orders ONE client's groups per
member, but two clients that fan out over members that include EACH OTHER
have no agreed order between their groups: each can hold its own slot
while the other's committed member entry waits behind it.  In the port
the wait is bounded: the client gives up after
``ici_fanout_xproc_timeout_s`` and degrades.  Deploy cross-process fan-out
with disjoint client and member roles, or one client per overlapping
member set.

Eager PyTorch compiles nothing, so there is no program cache:
``describe()["cache"]`` reads zero programs (a CUDA graph per key is the
compiled half's work, ROADMAP queue 1 item 5).

The degrade leg is the per-member RPC loop with the same bytes: a row of a
tensor operand rides its sub-call as a DEVICE block owned by the member's
rank (the answer crosses back on ``p2p_copy``); a numpy operand rides as
bytes, as in the JAX package.  :class:`CollectiveMerger` orders the answers
by sub-channel index, never by arrival, and merges them as the compiled
leg does, so both legs give equal results.

Degradation and revival ride the epoch policy of :mod:`..ici.plane_health`:
a failed attempt marks the route down with a reason and the call completes
on the RPC loop; the route re-probes once the epoch (this process's
registry transitions plus the pod's) moved past the one it died under (a
member's server restarting), or, for a transient reason (an execution that
raised, a refused announce), after ``ici_fanout_reprobe_s``.
"""
from __future__ import annotations

import atexit
import base64
import collections
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..butil import debug_sync as _dbg
from ..bthread.timer_thread import TimerThread
from ..butil import flags as _flags
from ..butil import logging as log
from ..butil.endpoint import SCHEME_ICI
from ..ici import collective as _coll
from ..ici import device_plane as _dp
from ..ici import fabric as _fab
from ..ici import ipc_pull as _ipc
from ..ici import plane_health as _ph
from ..ici import route as _route
from ..ici.mesh import IciMesh, ShardedTensor
from .collective_lowering import (MERGE_SUM, MERGE_GATHER, MERGE_CONCAT,
                                  MERGE_NONE, MAP_REPLICATE, MAP_SHARD)

_flags.define_flag("ici_fanout_collective", True,
                   "lower eligible Parallel/Partition fan-outs to the "
                   "compiled collective plane (off: always the per-member "
                   "RPC loop)")
_flags.define_flag("ici_fanout_xproc_timeout_s", 10.0,
                   "seconds the client waits for every remote member to "
                   "accept a collective fan-out announce, and then for "
                   "their results, before degrading to per-member RPCs")
_flags.define_flag("ici_fanout_reprobe_s", 5.0,
                   "seconds before a route downed by a TRANSIENT reason "
                   "(exec_failed / announce_refused) re-probes without "
                   "an epoch move; membership reasons stay epoch-gated")

# screen and degrade reasons (route counter labels)
R_XPROC = "xproc_uncompiled"      # remote member, no cross-process leg
R_MEMBER = "member_down"          # target device not serving the method
R_EXEC = "exec_failed"            # the execution raised mid-fan-out
R_KILLED = "member_killed"        # fault-plan kill fired mid-fan-out
R_ANNOUNCE = "announce_refused"   # a remote member refused/failed entry
R_TARGET = "target_not_ici"       # a sub-channel is not a fixed ici:// peer
R_MAPPER = "mapper"               # CallMapper not lowerable
R_MERGE = "merge_mismatch"        # client merge mode != registered mode
R_SHAPE = "shape"                 # sharded operand rows != fan-out width
R_UNREGISTERED = "unregistered"   # no device handler for the method
R_NO_CARRIER = "no_local_carrier"  # cross-process, no client-owned row

# transient reasons re-probe on a timer; membership reasons wait for the
# epoch to move
_TRANSIENT_REASONS = (R_EXEC, R_ANNOUNCE)


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

    _GUARDED_BY = {
        "_methods": "_lock",
        "_serving": "_lock",
        "_epoch": "_lock",
    }

    def __init__(self) -> None:
        self._lock = _dbg.make_lock("CollectiveRegistry._lock")
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
        self._publish_pod()

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

    def serving(self, device_id: int) -> bool:
        with self._lock:
            return self._serving.get(device_id, 0) > 0

    def serving_all(self, device_ids) -> bool:
        """One lock hold for a whole fan-out's liveness check."""
        with self._lock:
            s = self._serving
            return all(s.get(d, 0) > 0 for d in device_ids)

    def local_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def _publish_pod(self) -> None:
        """Advertise the registered method names in this process's pod
        record (the capability the screen of another member reads)."""
        from ..ici.pod import Pod
        pod = Pod.current()
        if pod is not None:
            pod.publish_collective(self.method_names())


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

    _GUARDED_BY = {
        "_next_assign": "_cv",
        "_next_exec": "_cv",
        "_aborted": "_cv",
    }

    def __init__(self) -> None:
        self._cv = threading.Condition(_dbg.make_lock("FanoutSequencer._lock"))
        self._next_assign = 0
        self._next_exec = 0
        self._aborted: set = set()

    def submit(self) -> int:
        with self._cv:
            seq = self._next_assign
            self._next_assign += 1
            return seq

    # fablint: lock-held(_cv)
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
    special case ``devices == (0, ..., n-1)``.

    A cross-process MERGE_NONE result holds only this process's rows:
    ``remote`` maps the index of each row another process keeps to that
    process's pid (its entry in ``rows`` is None), and reading such a row
    raises, as a remote shard of a JAX array is not addressable."""

    __slots__ = ("rows", "devices", "mesh", "remote")

    def __init__(self, rows, devices, mesh: IciMesh,
                 remote: Optional[Dict[int, int]] = None):
        rows = list(rows)
        remote = dict(remote or {})
        if len(rows) != len(devices):
            raise ValueError(f"FanoutRows: {len(rows)} rows for "
                             f"{len(devices)} devices")
        for i, (row, dev) in enumerate(zip(rows, devices)):
            if i in remote:
                continue
            if mesh.rank_of(row) != dev:
                raise ValueError(f"FanoutRows: row {i} is owned by rank "
                                 f"{mesh.rank_of(row)}, not {dev}")
        self.rows: List[torch.Tensor] = rows
        self.devices = tuple(devices)
        self.mesh = mesh
        self.remote = remote

    def _local_row(self) -> torch.Tensor:
        return next(r for i, r in enumerate(self.rows)
                    if i not in self.remote)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self.rows),) + tuple(self._local_row().shape))

    @property
    def dtype(self) -> torch.dtype:
        return self._local_row().dtype

    def __getitem__(self, i: int) -> torch.Tensor:
        pid = self.remote.get(i)
        if pid is not None:
            raise LookupError(f"FanoutRows: row {i} (ici://{self.devices[i]}"
                              f") is held by process {pid}")
        return self.rows[i]

    def stack(self) -> torch.Tensor:
        """One ``(n, *chunk)`` tensor on ``mesh.device(0)``."""
        if self.remote:
            i = min(self.remote)
            self[i]                       # raises, naming the owner
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


def _device_bytes(refs) -> torch.Tensor:
    """The bytes of DEVICE refs as one flat tensor: a view where they are
    adjacent slices of one block, else their concatenation on the
    device."""
    segs = []
    for r in refs:
        last = segs[-1] if segs else None
        if last is not None and last[0] is r.block \
                and last[1] + last[2] == r.offset:
            last[2] += r.length
        else:
            segs.append([r.block, r.offset, r.length])
    views = [b.data[o:o + n] for b, o, n in segs]
    return views[0] if len(views) == 1 else torch.cat(views)


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
        if refs and sum(r.length for r in refs) == len(att):
            # all on the device: an answer the read cut into several refs
            # of one block (a frame over the read's 64 MiB) is still one
            # view of it, never a round trip through the host
            t = _device_bytes(refs).view(dt)
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
    """One screened fan-out: everything ``execute`` needs.  ``leg`` is
    "local" or "xproc"; ``remote_owners`` maps each remote member's pid to
    the first of its ranks in the fan-out (where its announce goes).
    ``operand_shape``/``operand_dtype`` carry the announced shape on the
    member side, where no operand object exists."""
    __slots__ = ("method", "md", "devices", "operand", "mapping", "leg",
                 "remote_owners", "operand_shape", "operand_dtype")

    def __init__(self, method, md, devices, operand, mapping, leg="local",
                 remote_owners=None, operand_shape=(), operand_dtype="uint8"):
        self.method = method
        self.md = md
        self.devices = devices
        self.operand = operand
        self.mapping = mapping
        self.leg = leg
        self.remote_owners = remote_owners or {}
        self.operand_shape = operand_shape
        self.operand_dtype = operand_dtype


class CollectiveFanoutPlane:
    """The process's fan-out plane: the screen, the degrade/revive state
    machine and the two legs."""

    _instance: Optional["CollectiveFanoutPlane"] = None
    _ilock = threading.Lock()

    def __init__(self) -> None:
        self._health = _ph.register_plane(
            "collective", _dbg.make_lock("CollectiveFanoutPlane._health"),
            epoch_fn=self._epoch,
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
    def _epoch() -> int:
        """The revival clock: this process's registry transitions plus the
        pod's epoch when one is joined (a member re-advertising moves
        it)."""
        from ..ici.pod import Pod
        e = _registry.local_epoch()
        pod = Pod.current()
        if pod is not None:
            e += pod.epoch()
        return e

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
        # member liveness covers this process's ranks first; then a remote
        # rank must lie on the mesh, and is live when the pod lists an
        # owner serving the method (the JAX package's order)
        local = _local_devices()
        if not _registry.serving_all(d for d in devices if d in local):
            return None, R_MEMBER
        remote_owners: Dict[int, int] = {}
        remote = [d for d in devices if d not in local]
        if remote:
            for dev in remote:
                if dev >= mesh.size:
                    return None, R_TARGET
                owner = _pod_owner(dev, method_full_name)
                if owner is None:
                    return None, R_MEMBER
                remote_owners.setdefault(owner, dev)
            if not _dp.xproc_compiled_ok(mesh):
                return None, R_XPROC
            if len(remote) == len(devices):
                # the merged result lives on a client-owned row's rank
                return None, R_NO_CARRIER
        if not self.route_usable():
            return None, "route_down"
        return _Lowering(method_full_name, md, devices, operand, mapping,
                         "xproc" if remote_owners else "local",
                         remote_owners), ""

    def cache_stats(self) -> dict:
        return {"programs": 0, "building": 0}

    # ---- execution -----------------------------------------------------------
    def execute(self, low: _Lowering, cntl) -> Any:
        """Run one screened fan-out at its slot in the total order.
        Raises on any failure; the caller marks the route down and
        completes the call on the per-member loop.  Everything after the
        submit runs inside the slot, whose ``run`` always retires it."""
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
            if low.leg != "xproc":
                return self._enter(low, cntl)
            _sweep_orphans()
            call = _XprocCall(low)
            try:
                self._announce_xproc(low, seq, call)
                return self._enter(low, cntl, call)
            finally:
                call.finish()

        return self.sequencer.run(seq, entry, deadline=deadline)

    def _enter(self, low: _Lowering, cntl, call=None) -> Any:
        try:
            out = self._run_local(low) if call is None \
                else self._run_xproc(low, call)
            if isinstance(out, FanoutRows):
                last = out.rows[max(i for i in range(len(out.rows))
                                    if i not in out.remote)]
            else:
                last = out
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
        return _merge(md.merge, results, low.devices, mesh,
                      mesh.device(0), args)

    # -- cross-process leg: the client's half ---------------------------------
    def _run_xproc(self, low: _Lowering, call: "_XprocCall"):
        """The counterpart of the JAX ``_prepare_xproc`` program: the
        client's bodies on its own rows while the members run theirs,
        then one pull per remote result and the local leg's merge."""
        mesh = IciMesh.default()
        md = low.md
        local = _local_devices()
        shard = low.mapping == MAP_SHARD
        results: List[Optional[torch.Tensor]] = [None] * len(low.devices)
        for i, dev in enumerate(low.devices):
            if dev in local:
                arg = call.full[i] if shard else call.full
                r = md.handler(i, arg) if md.takes_index else md.handler(arg)
                results[i] = torch.as_tensor(r, device=mesh.device(dev))
        deadline = time.monotonic() + _flags.get_flag(
            "ici_fanout_xproc_timeout_s")
        carrier = mesh.device(call.carrier)
        for pid in sorted(call.committed):
            sock, rows = call.wait_result(pid, deadline)
            for row in rows:
                idx = int(row["idx"])
                if not 0 <= idx < len(results) or results[idx] is not None \
                        or low.devices[idx] in local:
                    raise CollectiveExecError(
                        R_EXEC, f"member pid {pid} returned row {idx}")
                out = _pull(sock, row["ext"], int(row["nbytes"]), carrier)
                results[idx] = out.view(_torch_dtype(row["dtype"])).reshape(
                    tuple(row["shape"]))
        if md.merge == MERGE_NONE:
            remote = {i: pid for pid, dev in call.owner_of.items()
                      for i in dev}
            return _merge(md.merge, results, low.devices, mesh, carrier,
                          [call.full], remote)
        missing = [i for i, r in enumerate(results) if r is None]
        if missing:
            raise CollectiveExecError(
                R_EXEC, f"no result for fan-out rows {missing}")
        return _merge(md.merge, results, low.devices, mesh, carrier)

    def _announce_xproc(self, low: _Lowering, seq: int,
                        call: "_XprocCall") -> None:
        """Tell every remote member process to enter this fan-out at
        ``seq``; wait for every accept, then COMMIT (two-phase: see
        :func:`on_remote_announce`).  A refusal or a timeout raises
        (R_ANNOUNCE) and the caller degrades in-call.  All accept waits
        share ONE deadline from the first announce, and a member parks
        for TWICE the timeout, so a GO that follows a full accept phase
        still lands inside every member's park window."""
        from ..rpc import fault_injection as _fi
        body = json.dumps(announce_body(low, seq, call)).encode()
        deadline = time.monotonic() + _flags.get_flag(
            "ici_fanout_xproc_timeout_s")
        waiters = []
        socks = {}
        try:
            for pid, dev in sorted(low.remote_owners.items()):
                sock = _member_sock(dev)
                if sock is None:
                    raise CollectiveExecError(
                        R_ANNOUNCE, f"no fabric route to member pid {pid}")
                socks[pid] = sock
                w = _AnnounceWaiter()
                with _announce_lock:
                    _announce_waiters[(call.uuid, pid)] = w
                waiters.append((pid, w))
                plan = _fi.fabric_active()
                if plan is not None:
                    plan.on_plane_op(sock, "collective")
                    if plan.on_collective_announce():
                        # a black hole: the member never sees the announce
                        continue
                try:
                    sock._ctrl_send(_fab._F_COLL_CALL, body)
                except OSError as e:
                    raise CollectiveExecError(
                        R_ANNOUNCE, f"announce to pid {pid} failed: {e}")
            for pid, w in waiters:
                if not w.event.wait(max(deadline - time.monotonic(), 0.001)):
                    raise CollectiveExecError(
                        R_ANNOUNCE, f"member pid {pid} never acknowledged "
                                    f"the fan-out announce")
                if not w.ok:
                    raise CollectiveExecError(
                        R_ANNOUNCE,
                        f"member pid {pid} refused entry: {w.reason}")
        finally:
            # an abandoned announce leaves no waiter behind (a late reply
            # then finds none)
            with _announce_lock:
                for pid in low.remote_owners:
                    _announce_waiters.pop((call.uuid, pid), None)
        # every member accepted: COMMIT, in sorted pid order
        go = json.dumps({"uuid": call.uuid, "cpid": call.cpid}).encode()
        for pid in sorted(socks):
            sock = socks[pid]
            call.commit(pid, sock, [i for i, d in enumerate(low.devices)
                                    if _pod_owner(d, low.method) == pid])
            try:
                sock._ctrl_send(_fab._F_COLL_GO, go)
            except OSError as e:
                raise CollectiveExecError(
                    R_ANNOUNCE, f"commit to pid {pid} failed: {e}")


def announce_body(low: _Lowering, seq: int, call: "_XprocCall") -> dict:
    """Frame 21's body: the JAX keys, then the port's ``xrows`` (the
    operand's export, one per fan-out index) and ``xrow_bytes``.  The
    announced shape is the stacked ``(n, ...)`` one under MAP_REPLICATE
    too, as the JAX program's."""
    shape = tuple(call.full.shape)
    if low.mapping == MAP_REPLICATE:
        shape = (len(low.devices),) + shape
    return {"method": low.method, "seq": seq,
            "devices": list(low.devices), "mapping": low.mapping,
            "merge": low.md.merge, "shape": list(shape),
            "dtype": _dtype_name(call.full.dtype),
            "uuid": call.uuid, "cpid": call.cpid,
            "xrows": call.xrows, "xrow_bytes": call.row_bytes}


def _merge(merge: str, results, devices, mesh: IciMesh, dev0,
           args=(), remote=None):
    """The merge both legs share: a left fold in fan-out order, a stack or
    a concatenation on ``dev0``; under MERGE_NONE each result stays with
    its rank (a result that is an operand row is copied, never claimed)."""
    if merge == MERGE_SUM:
        return _coll.fold(results, dev0)
    if merge == MERGE_GATHER:
        return _coll.gather(results, dev0)
    if merge == MERGE_CONCAT:
        return torch.cat([r.to(dev0) for r in results], dim=0)
    held = {a.untyped_storage().data_ptr() for a in args}
    remote = remote or {}
    rows = []
    for i, (dev, r) in enumerate(zip(devices, results)):
        if i in remote:
            rows.append(None)
            continue
        if r.untyped_storage().data_ptr() in held:
            r = r.clone()
        rows.append(mesh.own(r, dev))
    return FanoutRows(rows, devices, mesh, remote)


# ---------------------------------------------------------------------------
# The cross-process leg: shared pieces.
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    """A dtype as the wire names it (the JAX package's numpy names)."""
    return str(dt).replace("torch.", "")


_stats_lock = threading.Lock()
_xstats = {"client_calls": 0, "member_entries_run": 0, "rows_pulled": 0,
           "rows_exported": 0}


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _xstats[key] += n


def _pull(sock, ext_b64: str, nbytes: int, device: torch.device):
    """One row of a peer's export into a fresh flat uint8 tensor on
    ``device``: one ``p2p_copy`` launch through the socket's importer
    (the IPC mapping, cached per allocation), ordered before the caller's
    next op on the device."""
    ext, _ = _ipc.parse_ext(base64.b64decode(ext_b64), 0)
    row, ev, release = sock._importer.source(ext, nbytes)
    try:
        out, done = _dp.plane().pull(row, ev, device)
    finally:
        del row
        if release is not None:
            release()
    if done is not None:
        torch.cuda.current_stream(device).wait_event(done)
    _count("rows_pulled")
    return out


def _send(sock, ftype: int, msg: dict) -> bool:
    try:
        sock._ctrl_send(ftype, json.dumps(msg).encode())
        return True
    except OSError:
        return False


def _sock_dead(sock) -> bool:
    return sock.failed or sock._peer_gone()


class _AnnounceWaiter:
    __slots__ = ("event", "ok", "reason")

    def __init__(self):
        self.event = threading.Event()
        self.ok = False
        self.reason = ""


_announce_lock = _dbg.make_lock("collective_fanout._announce_lock")
_announce_waiters: Dict[Tuple[int, int], _AnnounceWaiter] = {}
# announce group ids: a counter, never id()-derived
_announce_counter = itertools.count(1)
# the client's calls in flight, uuid -> _XprocCall
_xproc_calls: Dict[int, "_XprocCall"] = {}
# scatter pins of calls that ended before every committed member reported:
# uuid -> (export, tensor, {pid: sock} still unreported, expiry)
_orphans: Dict[int, tuple] = {}


class _XprocCall:
    """One cross-process fan-out on the client: the operand's export (the
    scatter, pinned until every committed member has pulled), the
    committed members, and their results as they arrive."""

    def __init__(self, low: _Lowering):
        mesh = IciMesh.default()
        local = _local_devices()
        n = len(low.devices)
        self.uuid = next(_announce_counter)
        self.cpid = _own_pid()
        self.carrier = next(d for d in low.devices if d in local)
        self.committed: Dict[int, Any] = {}      # pid -> sock
        self.owner_of: Dict[int, List[int]] = {}  # pid -> fan-out indices
        self.results: Dict[int, tuple] = {}      # pid -> (sock, ok, msg)
        self._cv = threading.Condition(threading.Lock())
        self.export = None
        try:
            x = _as_tensor(low.operand)
            dev = mesh.device(self.carrier)
            if x.device != dev:
                # placement, as the local leg's device_put of a host operand
                x = x.to(dev)
            self.full = x.contiguous()
            flat = self.full.reshape(-1).view(torch.uint8)
            if low.mapping == MAP_SHARD:
                rb = flat.numel() // n
                slices = [(i * rb, rb) for i in range(n)]
            else:
                rb = flat.numel()
                slices = [(0, rb)] * n
            self.row_bytes = rb
            self.export, exts = _ipc.export_slices(flat, slices)
        except Exception as e:
            raise CollectiveExecError(
                R_EXEC, f"scatter export failed: {type(e).__name__}: {e}")
        self.xrows = [base64.b64encode(e).decode() for e in exts]
        with _announce_lock:
            _xproc_calls[self.uuid] = self
        _count("client_calls")

    def commit(self, pid: int, sock, indices: List[int]) -> None:
        with self._cv:
            self.committed[pid] = sock
            self.owner_of[pid] = indices

    def on_result(self, pid: int, sock, ok: bool, msg: dict) -> None:
        with self._cv:
            self.results[pid] = (sock, ok, msg)
            self._cv.notify_all()

    def wait_result(self, pid: int, deadline: float):
        """``(sock, rows)`` of member ``pid``'s COLL_RESULT; raises
        CollectiveExecError on its COLL_FAIL, its death or its silence
        past ``deadline``."""
        with self._cv:
            sock = self.committed[pid]
            while pid not in self.results:
                if _sock_dead(sock):
                    raise CollectiveExecError(
                        R_EXEC, f"member pid {pid} died before its result")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CollectiveExecError(
                        R_EXEC, f"member pid {pid} sent no result in time")
                self._cv.wait(min(left, 0.05))
            rsock, ok, msg = self.results[pid]
        if not ok:
            raise CollectiveExecError(
                R_EXEC, f"member pid {pid} failed: {msg.get('reason', '')}")
        return rsock, msg.get("rows", [])

    def finish(self) -> None:
        """The call is over: every committed member may release its
        results, and the scatter pin releases once every one of them has
        reported (a member that has not yet may still be pulling: its pin
        waits for its report, its death or twice the timeout)."""
        with _announce_lock:
            _xproc_calls.pop(self.uuid, None)
        rel = {"uuid": self.uuid, "cpid": self.cpid}
        with self._cv:
            committed = dict(self.committed)
            pending = {p: s for p, s in committed.items()
                       if p not in self.results}
        for sock in committed.values():
            _send(sock, _fab._F_COLL_RELEASE, rel)
        if self.export is None:
            return
        if not pending:
            self.export.release()
            return
        hold = 2 * _flags.get_flag("ici_fanout_xproc_timeout_s")
        expiry = time.monotonic() + hold
        with _announce_lock:
            _orphans[self.uuid] = (self.export, self.full, pending, expiry)
        # the pin goes at its expiry even if no later call or stats read
        # sweeps: a member silent to the end holds nothing past it
        TimerThread.instance().schedule_after(_sweep_orphans, hold + 0.05)


def _sweep_orphans(uuid: Optional[int] = None, pid: Optional[int] = None) \
        -> None:
    """Release the scatter pins whose last unreported member reported
    late (``uuid``/``pid``), died, or outlived twice the timeout."""
    now = time.monotonic()
    done = []
    with _announce_lock:
        for u, (exp, full, pending, expiry) in list(_orphans.items()):
            if u == uuid:
                pending.pop(pid, None)
            for p, s in list(pending.items()):
                if _sock_dead(s):
                    pending.pop(p)
            if not pending or expiry < now:
                done.append(_orphans.pop(u)[0])
    for exp in done:
        exp.release()


# ---------------------------------------------------------------------------
# The cross-process leg: the member's half.
# ---------------------------------------------------------------------------

_entry_lock = _dbg.make_lock("collective_fanout._entry_lock")
_entry_queue: "collections.deque" = collections.deque()
# (client pid, uuid) -> (sock, low, msg, expiry): accepted, not committed
_pending_entries: Dict[Tuple[int, int], tuple] = {}
# (client pid, uuid) -> (sock, [(export, tensor)], expiry): results the
# client has not released yet
_held_results: Dict[Tuple[int, int], tuple] = {}
_entry_wake = threading.Event()
_entry_stop = threading.Event()
_entry_thread: Optional[threading.Thread] = None

_GUARDED_BY_GLOBALS = {
    "_announce_waiters": "_announce_lock",
    "_announce_socks": "_announce_lock",
    "_entry_queue": "_entry_lock",
    "_pending_entries": "_entry_lock",
    "_entry_thread": "_entry_lock",
}


def on_frame(sock, ftype: int, msg: dict) -> None:
    """The fabric reader's dispatch of frames 21-24 and 41-43."""
    fab = _fab
    if ftype == fab._F_COLL_CALL:
        on_remote_announce(sock, msg)
    elif ftype in (fab._F_COLL_OK, fab._F_COLL_ERR):
        on_remote_reply(sock, msg, ok=ftype == fab._F_COLL_OK)
    elif ftype == fab._F_COLL_GO:
        on_remote_go(sock, msg)
    elif ftype in (fab._F_COLL_RESULT, fab._F_COLL_FAIL):
        on_remote_result(sock, msg, ok=ftype == fab._F_COLL_RESULT)
    elif ftype == fab._F_COLL_RELEASE:
        on_remote_release(sock, msg)


def on_remote_reply(sock, msg: dict, ok: bool) -> None:
    """Client side: a member's accept or refusal of one announce."""
    key = (int(msg.get("uuid", 0)), int(msg.get("pid", -1)))
    with _announce_lock:
        w = _announce_waiters.pop(key, None)
    if w is not None:
        w.ok = ok
        w.reason = msg.get("reason", "")
        w.event.set()


def on_remote_result(sock, msg: dict, ok: bool) -> None:
    """Client side: a member's results (or its failure) for one call.  A
    call that already gave up releases the member at once."""
    uuid, pid = int(msg.get("uuid", 0)), int(msg.get("pid", -1))
    with _announce_lock:
        call = _xproc_calls.get(uuid)
    if call is not None:
        call.on_result(pid, sock, ok, msg)
        return
    _send(sock, _fab._F_COLL_RELEASE, {"uuid": uuid, "cpid": _own_pid()})
    _sweep_orphans(uuid, pid)


def on_remote_announce(sock, msg: dict) -> None:
    """Member side, phase 1: a client proposed a fan-out.  Validate it and
    reply accept or refuse, PARKING the entry until the client's commit
    (two-phase: see :meth:`CollectiveFanoutPlane._announce_xproc`).  A
    parked entry expires after twice the announce timeout."""
    fab = _fab
    method = msg.get("method", "")
    reply = {"uuid": msg.get("uuid", 0), "pid": _own_pid()}
    md = _registry.method(method)
    refuse = reason = ""
    if md is None:
        refuse, reason = "method has no device handler here", R_UNREGISTERED
    elif not _dp.xproc_compiled_ok() or "xrows" not in msg:
        refuse, reason = ("no cross-process fan-out leg on this member",
                          R_XPROC)
    elif msg.get("merge") != md.merge or msg.get("mapping") != md.mapping:
        # a contract divergence (the two sides registered different
        # merge/mapping) refuses: the member would run another function
        refuse, reason = (
            f"collective contract mismatch: member has "
            f"{md.merge}/{md.mapping}, announce says "
            f"{msg.get('merge')}/{msg.get('mapping')}", R_MERGE)
    if refuse:
        reply["reason"] = refuse
        _route.record_collective("announce_refused", reason)
        _send(sock, fab._F_COLL_ERR, reply)
        return
    low = _Lowering(method, md, tuple(msg.get("devices", ())), None,
                    msg.get("mapping", MAP_SHARD), "xproc", {},
                    operand_shape=tuple(msg.get("shape", ())),
                    operand_dtype=msg.get("dtype", "uint8"))
    # parked for TWICE the timeout: the client's accept phase may take up
    # to one whole timeout before its GO goes out
    now = time.monotonic()
    expiry = now + 2 * _flags.get_flag("ici_fanout_xproc_timeout_s")
    key = (int(msg.get("cpid", -1)), int(msg.get("uuid", 0)))
    with _entry_lock:
        _sweep_pending_locked(now)
        _pending_entries[key] = (sock, low, msg, expiry)
        _ensure_runner_locked()          # it also expires the parked
    if not _send(sock, fab._F_COLL_OK, reply):
        with _entry_lock:
            _pending_entries.pop(key, None)


def on_remote_go(sock, msg: dict) -> None:
    """Member side, phase 2: the client committed.  The parked entry joins
    the entry runner's queue (runner order = GO arrival order, the
    client's commit order on this control channel)."""
    key = (int(msg.get("cpid", -1)), int(msg.get("uuid", 0)))
    with _entry_lock:
        _sweep_pending_locked(time.monotonic())
        parked = _pending_entries.pop(key, None)
        if parked is None:
            return                       # expired or never announced
        _entry_queue.append((key,) + parked[:3])
        _ensure_runner_locked()
    _route.record_collective("member_entries")
    _entry_wake.set()


# fablint: lock-held(_entry_lock)
def _ensure_runner_locked() -> None:
    """Start the entry runner if it is not running.  Caller holds
    ``_entry_lock``."""
    global _entry_thread
    if _entry_thread is None or not _entry_thread.is_alive():
        _entry_stop.clear()
        _entry_thread = threading.Thread(
            target=_entry_loop, name="collective_fanout_entry", daemon=True)
        _entry_thread.start()


def on_remote_release(sock, msg: dict) -> None:
    """Member side: the client pulled this call's results (or gave up):
    their pins release."""
    key = (int(msg.get("cpid", -1)), int(msg.get("uuid", 0)))
    with _entry_lock:
        held = _held_results.pop(key, None)
    if held is not None:
        _release_held(held[1])


def _release_held(held) -> None:
    for exp, _t in held:
        exp.release()


# fablint: lock-held(_entry_lock)
def _sweep_pending_locked(now: float) -> None:
    """Drop parked entries whose commit never came (the client degraded
    after this member's accept), and held results whose client died or
    never released them.  Caller holds ``_entry_lock``."""
    stale = [k for k, v in _pending_entries.items() if v[3] < now]
    for k in stale:
        _pending_entries.pop(k, None)
    if stale:
        _route.record_collective("member_entry_expired", n=len(stale))
    gone = [k for k, (s, _h, exp) in _held_results.items()
            if exp < now or _sock_dead(s)]
    for k in gone:
        _release_held(_held_results.pop(k)[1])


def _entry_loop() -> None:
    """The member's one entry runner: committed entries in GO order, each
    at a slot of this process's sequencer (a process that is both a
    client and a member never runs two fan-outs at once).  Also sweeps
    the parked and held tables once a second."""
    plane = CollectiveFanoutPlane.instance()
    while not _entry_stop.is_set():
        _entry_wake.wait(1.0)
        with _entry_lock:
            _sweep_pending_locked(time.monotonic())
            if not _entry_queue:
                _entry_wake.clear()
                continue
            key, sock, low, msg = _entry_queue.popleft()
        seq = plane.sequencer.submit()
        try:
            plane.sequencer.run(
                seq, lambda: _member_enter(key, sock, low, msg))
        except Exception as e:
            _route.record_collective("member_entry_failed", R_EXEC)
            log.warning("collective fan-out member entry failed: %s", e)
            _send(sock, _fab._F_COLL_FAIL,
                  {"uuid": key[1], "pid": _own_pid(),
                   "reason": f"{type(e).__name__}: {e}"})


def _member_enter(key, sock, low: _Lowering, msg: dict) -> None:
    """One member entry: compute, hold the results until the client's
    release, and report (COLL_RESULT)."""
    rows, held = member_compute(sock, low, msg, _local_devices())
    expiry = time.monotonic() + 2 * _flags.get_flag(
        "ici_fanout_xproc_timeout_s")
    with _entry_lock:
        _held_results[key] = (sock, held, expiry)
    _count("member_entries_run")
    _send(sock, _fab._F_COLL_RESULT,
          {"uuid": key[1], "pid": _own_pid(), "rows": rows})


def member_compute(sock, low: _Lowering, msg: dict, local) -> tuple:
    """A member's work for one fan-out: pull each row of ``local`` ranks
    from the client's export (one launch each, through ``sock``'s
    importer), run the body on it, export each result.  Returns ``(the
    COLL_RESULT rows, [(export, result)] to hold until the client's
    release)``, once this process's work on the card is done: the report
    says its pulls are, so the client may release its operand."""
    mesh = IciMesh.default()
    md = low.md
    xrows = msg["xrows"]
    rb = int(msg["xrow_bytes"])
    dt = _torch_dtype(low.operand_dtype)
    row_shape = tuple(low.operand_shape[1:])
    rows, held, synced = [], [], set()
    try:
        for i, dev in enumerate(low.devices):
            if dev not in local:
                continue
            device = mesh.device(dev)
            arg = _pull(sock, xrows[i], rb, device).view(dt).reshape(
                row_shape)
            r = md.handler(i, arg) if md.takes_index else md.handler(arg)
            r = torch.as_tensor(r, device=device)
            if device.type == "cuda":
                synced.add(device)
            if md.merge == MERGE_NONE:
                continue                 # the member's rows stay here
            r = r.contiguous()
            exp = _ipc.export_row(r.reshape(-1).view(torch.uint8))
            held.append((exp, r))
            _count("rows_exported")
            rows.append({"idx": i, "ext": base64.b64encode(exp.ext).decode(),
                         "nbytes": r.numel() * r.element_size(),
                         "shape": list(r.shape), "dtype": _dtype_name(r.dtype)})
        for device in synced:
            torch.cuda.current_stream(device).synchronize()
    except Exception:
        _release_held(held)
        raise
    return rows, held


@atexit.register
def _quiesce_entry_runner() -> None:
    """Stop the entry runner before the interpreter finalizes: a daemon
    cut off inside a torch call aborts the process."""
    _entry_stop.set()
    _entry_wake.set()
    with _entry_lock:
        t = _entry_thread
    if t is not None and t.is_alive() and t is not threading.current_thread():
        t.join(5.0)


def xproc_stats() -> dict:
    """The cross-process leg's counts and tables, for the /ici page and
    the phases' checks."""
    _sweep_orphans()
    with _entry_lock:
        _sweep_pending_locked(time.monotonic())
        tables = {"parked": len(_pending_entries),
                  "held": len(_held_results), "queued": len(_entry_queue)}
    with _announce_lock:
        tables.update(waiters=len(_announce_waiters),
                      calls=len(_xproc_calls), orphans=len(_orphans))
    with _stats_lock:
        tables.update(_xstats)
    return tables


def _own_pid() -> int:
    """This process's fabric process id (``local_pid()``'s source); 0
    with no fabric node, as the JAX package's single process."""
    node = _fab.FabricNode.instance()
    return node.process_id if node is not None else 0


_announce_socks: Dict[int, Any] = {}


def _member_sock(dev: int):
    """A live fabric control channel to the member serving ``dev``:
    prefer a live socket to it (the per-member RPC traffic may already
    have dialed one), else dial one and cache it; a replaced socket is
    failed with ECLOSE."""
    from ..rpc.socket import list_sockets
    for s in list_sockets():
        if isinstance(s, _fab.FabricSocket) and s.remote_dev == dev \
                and not _sock_dead(s):
            return s
    with _announce_lock:
        stale = _announce_socks.get(dev)
    if stale is not None and not _sock_dead(stale):
        return stale
    try:
        s = _fab.connect_any(IciMesh.default().endpoint(dev))
    except Exception:
        return None
    if not isinstance(s, _fab.FabricSocket):
        return None
    with _announce_lock:
        prev = _announce_socks.get(dev)
        _announce_socks[dev] = s
    if prev is not None and prev is not s:
        from ..rpc import errors as _err
        prev.set_failed(_err.ECLOSE, "announce socket replaced")
    return s


_local_devs_lock = _dbg.make_lock("collective_fanout._local_devs_lock")
_local_devs_memo: Tuple = (None, None, frozenset())


def _local_devices() -> frozenset:
    """The ranks this process owns: the fabric node's published block, or
    every rank with no node.  Memoized per mesh generation (and node)."""
    global _local_devs_memo
    gen = IciMesh.generation
    node = _fab.FabricNode.instance()
    memo = _local_devs_memo
    if memo[0] == gen and memo[1] is node:
        return memo[2]
    local = frozenset(node.devices) if node is not None \
        else frozenset(range(IciMesh.default().size))
    with _local_devs_lock:
        _local_devs_memo = (gen, node, local)
    return local


def _pod_owner(dev: int, method: str) -> Optional[int]:
    """The pid of the pod member serving ``ici://dev`` (not draining it)
    with a device handler for ``method`` in its ``coll``, or None."""
    from ..ici.pod import Pod, UP
    pod = Pod.current()
    if pod is None:
        return None
    for m in pod.members().values():
        if m.state == UP and dev in m.serving and dev not in m.draining \
                and method in m.coll:
            return m.pid
    return None


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
        "xproc": xproc_stats(),
    }
