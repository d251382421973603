"""Device data plane: payloads cross the mesh through the p2p_copy kernel.

This is the analogue of the reference's RDMA datapath proper
(src/brpc/rdma/rdma_endpoint.cpp:771 ``ibv_post_send`` posting registered
IOBuf blocks straight on the NIC, :926 freeing send buffers on CQ
completion): a DEVICE-block payload owned by one logical rank moves to
another rank through one launch of the hand-written copy kernel
(:mod:`.p2p_copy`), device memory to device memory, with no host in the
datapath.  The kernel is the only byte mover on the card: a build or
launch failure fails the transfer and raises, it never falls through to a
library copy.

QP semantics (rdma_endpoint.h:37-108):

  * ``post_send(t, src, dst)`` posts a work request and returns a
    :class:`DeviceTransfer` (the WR handle).  Nothing moves yet — like a
    posted SGE, the source tensor is pinned by reference until completion.
    On the card an event is recorded on the caller's current stream, so
    the copy never reads a source the caller is still writing.
  * a descriptor ``(uuid, nbytes)`` rides the transport's delivery path;
  * the receiver ``post_recv(uuid)``s the matching recv — the rendezvous:
    the plane allocates a fresh buffer on the dst rank and launches the
    kernel on its own stream, after the posted event;
  * completion is a :class:`bthread.device_waiter.DeviceCompletion` (the
    CQ entry), signaled from the per-device completion poller once an
    event recorded after the launch has fired; the source pin releases
    exactly then (the :926 discipline).  ``record_stream`` keeps the
    caching allocator from recycling the source or the output early.

Failure semantics: a refused post raises :class:`DevicePlaneError` before
any descriptor exists.  An in-process posted send whose recv never arrives
is reaped after ``ici_device_plane_match_timeout_s`` and fails only that
transfer; a server's lame-duck stop whose grace expired reaps the sends
posted before its drain began (``fail_pending``).  A failed transfer
releases its source pin, and nothing falls back to another route.

rpcz: a transfer posted while an RPC span is in scope (the client span
during a channel's write, the server span in a handler) opens a transfer
span parented under it, which carries the transfer's ``posted``, ``recv
enqueued``, ``matched``, ``complete pin_held_us=`` or ``failed``
annotations.  The post reads the rpcz flag once and the transfer keeps
the answer (``traced``): with rpcz off no annotation is paid.  Traced or
not, every finished transfer leaves one tuple of its timestamps in the
64-deep ring the /ici page reads (``recent_transfers``).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..butil import custody_ledger as _ledger
from ..butil import debug_sync as _dbg
from ..butil import flags as _flags
from ..bthread.device_waiter import DeviceCompletion, DeviceEventDispatcher
from ..rpc import span as _span

# the rpcz flag, read as one attribute load on the transfer path
_rpcz = _span._rpcz_flag
from .mesh import IciMesh
from .p2p_copy import p2p_copy

_flags.define_flag("ici_device_plane", True,
                   "move DEVICE payloads through the p2p_copy kernel "
                   "(the no-host datapath) where eligible")
_flags.define_flag("ici_device_plane_threshold", 64 * 1024,
                   "min DEVICE payload bytes routed through the device "
                   "plane (smaller payloads keep the lower-fixed-cost "
                   "mesh.device_put path)", _flags.positive_integer)
_flags.define_flag("ici_device_plane_host_mesh", False,
                   "engage the device plane on a CPU (host-memory) mesh "
                   "too, where the kernel's plain version moves the bytes; "
                   "the code path for CI")
_flags.define_flag("ici_device_plane_match_timeout_s", 30.0,
                   "seconds a posted send waits for its matching recv "
                   "before failing (peer died post-descriptor)")
_flags.define_flag("ici_device_plane_xproc_compiled", "auto",
                   "run the compiled fan-out's cross-process leg: 'auto' "
                   "(on a CUDA mesh), 'on' or 'off'")


class DevicePlaneError(ConnectionError):
    """A post was refused before any descriptor went out."""


# transfer states (WR lifecycle)
POSTED = "posted"          # send posted, awaiting the matching recv
MATCHED = "matched"        # rendezvous done, copy kernel launched
COMPLETE = "complete"      # payload resident at dst; source released
FAILED = "failed"


class DeviceTransfer:
    """One posted work request: uuid-correlated, completion-signaled.

    ``out`` is the dst-rank flat uint8 tensor once MATCHED (written by the
    kernel; physically complete at COMPLETE, which is when the source pin
    releases).  ``wait``/``poll``/``add_done_callback`` are the CQ
    interface (see DeviceCompletion)."""

    __slots__ = ("uuid", "src_dev", "dst_dev", "nbytes", "state", "error",
                 "out", "completion", "posted_ns", "matched_ns",
                 "complete_ns", "mesh", "_src_arr", "_posted_event",
                 "_releases", "_lock", "traced", "trace_id", "parent_span_id",
                 "span", "remote")

    def __init__(self, uuid: int, src_dev: int, dst_dev: int, nbytes: int,
                 src_arr: Optional[torch.Tensor], mesh: IciMesh,
                 traced: bool = False, trace_id: int = 0,
                 parent_span_id: int = 0):
        self.uuid = uuid
        self.src_dev = src_dev
        self.dst_dev = dst_dev
        self.nbytes = nbytes
        self.state = POSTED
        self.error = ""
        self.out: Optional[torch.Tensor] = None
        self.completion = DeviceCompletion()
        self.posted_ns = time.monotonic_ns()
        self.matched_ns = 0
        self.complete_ns = 0
        self.mesh = mesh
        self._src_arr = src_arr        # the pin (rdma_endpoint.cpp:926)
        self._posted_event = None
        self._releases: List[Callable[[], None]] = []
        self._lock = _dbg.make_lock("DeviceTransfer._lock")
        # posted with rpcz on: annotated, and its timeline kept.  With an
        # RPC span in scope as well, the transfer owns a span of its own
        # in that trace
        self.traced = traced
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.span = None
        # the cross-process leg's record: the sender's export (held until
        # PULLED) or the receiver's parsed descriptor extension
        self.remote = None
        if trace_id:
            self.span = _span.start_transfer_span(
                f"device_plane ici://{src_dev}->{dst_dev} {nbytes}B",
                trace_id, parent_span_id)

    # -- source pin ------------------------------------------------------
    def add_source_release(self, cb: Optional[Callable[[], None]]) -> None:
        """Called exactly once when the source block may be reused
        (completion OR failure — either way the transfer holds no more
        references)."""
        if cb is None:
            return
        with self._lock:
            if self.state not in (COMPLETE, FAILED):
                self._releases.append(cb)
                return
        cb()

    def source_array(self) -> Optional[torch.Tensor]:
        return self._src_arr

    def _release_source(self) -> None:
        with self._lock:
            cbs, self._releases = self._releases, []
            self._src_arr = None
            self._posted_event = None
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass

    # -- CQ interface ----------------------------------------------------
    def poll(self) -> bool:
        return self.completion.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        return self.completion.wait(timeout)

    def add_done_callback(self, cb: Callable[[int], None]) -> None:
        self.completion.add_done_callback(cb)

    def timeline(self) -> tuple:
        """The fields :meth:`describe` renders, as one tuple (cheap to
        keep: no tensor, no formatting)."""
        return (self.uuid, self.src_dev, self.dst_dev, self.nbytes,
                self.state, self.error, self.posted_ns, self.matched_ns,
                self.complete_ns)

    def describe(self) -> dict:
        return _describe(self.timeline())


def _describe(timeline: tuple) -> dict:
    (uuid, src, dst, nbytes, state, error, posted_ns, matched_ns,
     complete_ns) = timeline
    return {
        "uuid": f"{uuid:#x}",
        "route": f"ici://{src} -> ici://{dst}",
        "nbytes": nbytes,
        "state": state,
        "error": error,
        "posted_to_matched_us": ((matched_ns - posted_ns) // 1000
                                 if matched_ns else -1),
        "matched_to_complete_us": ((complete_ns - matched_ns) // 1000
                                   if complete_ns else -1),
    }


def mesh_index_of(arr: torch.Tensor, mesh: Optional[IciMesh] = None) -> int:
    """The rank owning a tensor's storage in ``mesh`` (default: the
    default mesh); -1 when off-mesh."""
    return (mesh or IciMesh.default()).rank_of(arr)


def platform_allows(mesh: Optional[IciMesh] = None) -> bool:
    """The plane engages on a CUDA mesh (default: the default mesh); a
    CPU mesh opts in through ``ici_device_plane_host_mesh`` (the JAX
    package's host-mesh rule)."""
    mesh = mesh or IciMesh.default()
    return (mesh.device_type == "cuda"
            or bool(_flags.get_flag("ici_device_plane_host_mesh")))


def eligible(nbytes: int, mesh: Optional[IciMesh] = None, src: int = -1,
             dst: int = -1) -> bool:
    """Route this payload device-plane?  Flag + threshold + platform of
    ``mesh`` (default: the default mesh).  The route ``src`` -> ``dst``
    does not decide it: ranks on different cards are eligible too, and
    ``post_send`` refuses them (the kernel's peer-pointer leg is not built
    yet) so the write fails, rather than moving the bytes with a library
    copy."""
    return (bool(_flags.get_flag("ici_device_plane"))
            and nbytes >= _flags.get_flag("ici_device_plane_threshold")
            and platform_allows(mesh))


def xproc_compiled_ok(mesh: Optional[IciMesh] = None) -> bool:
    """Does this process run the compiled fan-out's cross-process leg
    (:mod:`..channels.collective_fanout`)?  The flag
    ``ici_device_plane_xproc_compiled``: "on" and "off" force it; "auto"
    is true where the leg's bytes move on the card, a CUDA mesh, and false
    on a CPU mesh, as the JAX package's "auto" is false off the TPU.
    Forced "on" over a CPU mesh, the leg runs on the plain carrier of
    :mod:`.ipc_pull` (shared-memory segments, the copy's plain version).

    In the port this flag gates the fan-out only: a kind-4 transfer of
    the fabric always moves on the IPC pull, whatever it says."""
    mode = _flags.get_flag("ici_device_plane_xproc_compiled")
    if mode == "on":
        return True
    if mode == "off":
        return False
    try:
        return (mesh or IciMesh.default()).device_type == "cuda"
    except Exception:
        return False


class DevicePlane:
    """Per-process device plane: the posted-WR table and one copy stream
    per CUDA device."""

    _GUARDED_BY = {
        "_pending": "_lock",
        "_active": "_lock",
        "_streams": "_lock",
        "_next_uuid": "_lock",
        "transfers": "_lock",
        "bytes_sent": "_lock",
        "bytes_recv": "_lock",
        "kernel_builds": "_lock",
        "build_failures": "_lock",
        "match_timeouts": "_lock",
        "remote_received": "_lock",
        "remote_sent": "_lock",
    }

    # fablint custody contract: every tracked transfer (its source pin
    # rides the _active entry) must untrack — completion, failure, and
    # the lame-duck fail_pending sweep are the exits.  The post sites
    # carry custody-moved markers because the release fires from the
    # completion poller, not on the posting path.
    _CUSTODY = {"_track": ("_untrack",)}

    _instance: Optional["DevicePlane"] = None
    _ilock = threading.Lock()

    def __init__(self):
        self._lock = _dbg.make_lock("DevicePlane._lock")
        self._pending: Dict[int, DeviceTransfer] = {}   # posted sends
        self._active: set = set()      # posted-but-incomplete (drain gate)
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        # the last finished transfers' timelines, traced or not (not the
        # transfers: those hold their tensors)
        self._recent: "collections.deque" = collections.deque(maxlen=64)
        self._next_uuid = 1
        self.transfers = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        # one kernel serves every size and route, so the JAX plane's
        # program cache and its fallbacks have no counterpart: what is
        # left to count is building that kernel and failing to
        self.kernel_builds = 0
        self.build_failures = 0      # posts refused; the write fails
        self.match_timeouts = 0
        # receiver halves of cross-process transfers whose pull launched
        # (each is one launch of the copy kernel; not in stats(), whose
        # keys are the JAX plane's and the build counters)
        self.remote_received = 0
        # sender halves of cross-process transfers completed at PULLED
        # (no launch here: the receiver pulled), so a process's launches
        # are ``transfers - remote_sent``
        self.remote_sent = 0

    @classmethod
    def instance(cls) -> "DevicePlane":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = DevicePlane()
            return cls._instance

    def mesh(self) -> IciMesh:
        """The mesh a post without one addresses: the default mesh."""
        return IciMesh.default()

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device)
            return s

    def order_after_copies(self, device: torch.device) -> None:
        """Make ``device``'s current stream wait for every copy the plane
        has launched there so far: a consumer of a delivered payload
        orders its kernels after the copy on the device, with no host
        sync.  (Delivery already waits for the copy's completion event;
        this states the order on the device as well.)"""
        with self._lock:
            stream = self._streams.get(device)
        if stream is not None:
            torch.cuda.current_stream(device).wait_stream(stream)

    def sync_copies(self, device: torch.device) -> None:
        """Block until every copy the plane launched on ``device`` has
        finished (before a mapping those copies read is closed)."""
        with self._lock:
            stream = self._streams.get(device)
        if stream is not None:
            stream.synchronize()

    # ---- QP interface --------------------------------------------------
    def next_uuid(self) -> int:
        with self._lock:
            u = self._next_uuid
            self._next_uuid += 1
            return u

    def post_send(self, arr: torch.Tensor, src_dev: int, dst_dev: int,
                  mesh: Optional[IciMesh] = None, uuid: Optional[int] = None,
                  remote: bool = False, socket=None) -> DeviceTransfer:
        """Post one send WR.  ``arr``: flat uint8 tensor owned by rank
        ``src_dev`` of ``mesh`` (default: the default mesh).  Raises
        DevicePlaneError (before any descriptor exists) when refused: by
        the fabric fault plan's ``device_plane_fail_posts`` (``socket``,
        the posting socket, is what its ``match`` sees), or by a route the
        plane cannot serve.

        ``remote=True`` is the sender half of a cross-process transfer
        (``dst_dev`` lives in another process; ``uuid`` is the fabric's):
        it is not matched in this process, the fabric exports the source
        for the receiver's pull and completes it at the peer's PULLED
        (:meth:`finish_remote`)."""
        from ..rpc import fault_injection as _fi
        plan = _fi.fabric_active()
        if plan is not None and plan.on_device_post(socket):
            raise DevicePlaneError("injected device-plane post refusal")
        if src_dev == dst_dev:
            raise DevicePlaneError("device plane is point-to-point; "
                                   "same-rank payloads are ref passes")
        mesh = mesh or IciMesh.default()
        if arr.dtype != torch.uint8 or arr.dim() != 1:
            raise DevicePlaneError("device plane moves flat uint8 tensors")
        if not remote and mesh.device(src_dev) != mesh.device(dst_dev):
            raise DevicePlaneError(
                f"ranks {src_dev} and {dst_dev} live on {mesh.device(src_dev)}"
                f" and {mesh.device(dst_dev)}; the cross-card leg is not "
                "implemented")
        if arr.is_cuda:
            # build NOW: a build error must surface before the descriptor
            # is committed to any wire
            if not p2p_copy.built:
                try:
                    p2p_copy.build()
                except Exception as e:
                    with self._lock:
                        self.build_failures += 1
                    raise DevicePlaneError(f"p2p_copy build failed: {e}")
                with self._lock:
                    self.kernel_builds += 1
        # trace context at post time: the active client span (a channel's
        # write) or the server span of the handler posting
        traced = _rpcz.value
        tid, psid = (_span.current_trace_context() if traced else (0, 0))
        t = DeviceTransfer(self.next_uuid() if uuid is None else uuid,
                           src_dev, dst_dev, int(arr.shape[0]), arr, mesh,
                           traced=traced, trace_id=tid, parent_span_id=psid)
        if arr.is_cuda and not remote:
            # (a remote send's exporter records an interprocess event)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(arr.device))
            t._posted_event = ev
        self._track(t, pending=not remote)  # fablint: custody-moved(completion-path) the completion (_matched's done) or _fail untracks when the transfer completes or dies; fail_pending and the match-timeout sweep reap the orphans
        if traced:
            self._annotate(t, "posted")
        self._sweep_stale()
        return t

    def post_recv(self, uuid: int) -> DeviceTransfer:
        """In-process rendezvous: match the posted send and launch the
        copy.  Raises KeyError when no matching send is pending (reaped by
        the match timeout, or never posted).  A launch failure fails the
        transfer and re-raises."""
        with self._lock:
            t = self._pending.pop(uuid, None)
        if t is None:
            raise KeyError(f"device plane: no posted send {uuid:#x}")
        if t.traced:
            self._annotate(t, "recv enqueued")
        try:
            out, done_event = self._run(t)
        except Exception as e:
            self._fail(t, f"copy kernel failed: {e}")
            raise
        self._matched(t, out, done_event)
        return t

    def transfer_local(self, arr: torch.Tensor, src_dev: int, dst_dev: int,
                       socket=None) -> DeviceTransfer:
        """post_send and its in-process rendezvous in one call; raises
        DevicePlaneError when the post is refused."""
        t = self.post_send(arr, src_dev, dst_dev, socket=socket)
        return self.post_recv(t.uuid)

    # ---- fabric (cross-process) halves ---------------------------------
    def post_recv_remote(self, uuid: int, nbytes: int, src_dev: int,
                         dst_dev: int, mesh: Optional[IciMesh] = None,
                         trace_id: int = 0,
                         parent_span_id: int = 0) -> DeviceTransfer:
        """Receiver half of a cross-process transfer: the kind-4
        descriptor arrived on the fabric's control channel; register the
        recv WR.  The pull itself runs at the transfer's slot in the
        sequencer's total order (:meth:`execute_remote`).  The trace
        context comes off the descriptor, so this half joins the
        sender's trace."""
        mesh = mesh or IciMesh.default()
        traced = bool(trace_id) or _rpcz.value
        t = DeviceTransfer(uuid, src_dev, dst_dev, nbytes, None, mesh,
                           traced=traced, trace_id=trace_id,
                           parent_span_id=parent_span_id)
        self._track(t)  # fablint: custody-moved(completion-path) execute_remote's completion or fail_transfer untracks when the pull completes or dies
        if traced:
            self._annotate(t, "recv enqueued")
        return t

    def execute_remote(self, t: DeviceTransfer, src: torch.Tensor,
                       ready_event=None) -> None:
        """The receiver's pull: one launch of the copy kernel from
        ``src`` (the sender's row, mapped into this process) into a fresh
        tensor of the dst rank, on the plane stream after ``ready_event``
        (the sender's interprocess event, recorded after its producer).
        Completion fires when the copy's own event did.  A failure
        raises and leaves the transfer to the caller, which tells the
        sender before it fails it (:meth:`fail_transfer`); no other byte
        mover stands in."""
        try:
            out, done_event = self.pull(src, ready_event,
                                        t.mesh.device(t.dst_dev))
            out = t.mesh.register(out, t.dst_dev)
        except Exception as e:
            raise RuntimeError(f"remote execution failed: {e}") from None
        self._matched(t, out, done_event)

    def pull(self, src: torch.Tensor, ready_event,
             device: torch.device):
        """One launch of the copy kernel from ``src`` (a peer's row,
        mapped into this process) into a fresh flat uint8 tensor on
        ``device``, on the plane stream after ``ready_event`` (the peer's
        interprocess event, recorded after its producer) and after the
        caller's current stream.  Returns ``(out, event recorded after the
        launch)``; on the CPU the copy is done on return and the event is
        None.  Raises on a refused launch: nothing else moves the bytes."""
        out = torch.empty(src.numel(), dtype=torch.uint8, device=device)
        if not out.is_cuda:
            p2p_copy(src, out)
            return out, None
        caller = torch.cuda.current_stream(device)
        stream = self._stream(device)
        if ready_event is not None:
            stream.wait_event(ready_event)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            p2p_copy(src, out)
            done_event = torch.cuda.Event()
            done_event.record(stream)
        out.record_stream(stream)
        return out, done_event

    def finish_remote(self, t: DeviceTransfer) -> None:
        """Complete the sender half of a cross-process transfer: the
        receiver's PULLED says its copy finished, so the source pin
        releases now (the rdma_endpoint.cpp:926 discipline)."""
        self._matched(t, None, None)

    def fail_transfer(self, t: DeviceTransfer, reason: str) -> None:
        """Fail a transfer that can never execute (its socket died, its
        pull was refused): completion fires with an error and the source
        pin releases."""
        self._fail(t, reason)

    def annotate_transfer(self, t: DeviceTransfer, what: str) -> None:
        """An annotation from outside the plane (the fabric's sequencer)
        onto a traced transfer."""
        if t.traced:
            self._annotate(t, what)

    # ---- execution -----------------------------------------------------
    def _run(self, t: DeviceTransfer):
        """One launch of the copy kernel from the src rank's tensor into a
        fresh dst-rank tensor.  Returns (out, event recorded after the
        launch — None on a CPU mesh, where the copy is done on return)."""
        src = t.source_array()
        dst_device = t.mesh.device(t.dst_dev)
        if not src.is_cuda:
            out = torch.empty(t.nbytes, dtype=torch.uint8, device=dst_device)
            p2p_copy(src, out)
            return t.mesh.register(out, t.dst_dev), None
        caller = torch.cuda.current_stream(dst_device)
        out = torch.empty(t.nbytes, dtype=torch.uint8, device=dst_device)
        stream = self._stream(dst_device)
        # the plane stream starts after the posted event (the source is
        # written) and after the caller's stream reached this allocation
        # (the output block's previous tenant is done)
        stream.wait_event(t._posted_event)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            p2p_copy(src, out)
            done_event = torch.cuda.Event()
            done_event.record(stream)
        src.record_stream(stream)
        out.record_stream(stream)
        return t.mesh.register(out, t.dst_dev), done_event

    def _matched(self, t: DeviceTransfer, out: Optional[torch.Tensor],
                 done_event) -> None:
        t.state = MATCHED
        t.matched_ns = time.monotonic_ns()
        t.out = out
        if t.traced:
            self._annotate(t, "matched")
        # bytes_sent is a sender counter: the receiver half of a
        # cross-process transfer holds no source (an in-process transfer
        # is both halves and counts both directions)
        sender = t.source_array() is not None
        with self._lock:
            self.transfers += 1
            if sender:
                self.bytes_sent += t.nbytes
            if out is not None and not sender:
                self.remote_received += 1
            elif out is None and sender:
                self.remote_sent += 1

        def done() -> None:
            t.state = COMPLETE
            t.complete_ns = time.monotonic_ns()
            if out is not None:
                with self._lock:
                    self.bytes_recv += t.nbytes
            t._release_source()
            self._untrack(t)
            if t.traced:
                # how long the source block stayed pinned
                self._annotate(t, "complete pin_held_us="
                                  f"{(t.complete_ns - t.posted_ns) // 1000}")
                self._close_span(t, 0)
            self._recent.append(t.timeline())
            t.completion.signal(0)

        if done_event is None:
            done()
        else:
            # the plane stream is the CQ: completion fires when the
            # kernel's output is physically resident at dst
            DeviceEventDispatcher.instance().on_event(
                done_event, out.device, done)

    def _fail(self, t: DeviceTransfer, reason: str) -> None:
        t.state = FAILED
        t.error = reason
        t._release_source()
        self._untrack(t)
        if t.traced:
            self._annotate(t, f"failed: {reason}")
            self._close_span(t, 1)
        self._recent.append(t.timeline())
        t.completion.signal(1)

    # ---- drain barrier -------------------------------------------------
    def _track(self, t: DeviceTransfer, pending: bool = False) -> None:
        _ledger.acquire("dev.transfer", (id(self), t.uuid))
        with self._lock:
            if pending:
                self._pending[t.uuid] = t
            self._active.add(t)

    def _untrack(self, t: DeviceTransfer) -> None:
        # non-strict: discard is idempotent (a fail_pending sweep can
        # race the CQ callback), so a second untrack must stay a no-op
        _ledger.release("dev.transfer", (id(self), t.uuid))
        with self._lock:
            self._active.discard(t)

    def active_transfers(self) -> int:
        """Posted-but-incomplete transfers (each holds a source pin): the
        server's drain gate waits for this to reach zero.  A launched
        copy leaves the set only when the completion poller has seen its
        event, so zero means the bytes are resident, not just enqueued."""
        with self._lock:
            return len(self._active)

    def fail_pending(self, reason: str,
                     posted_before_ns: Optional[int] = None) -> int:
        """Fail posted sends whose rendezvous never came (a lame-duck
        grace expired): their completions fire with an error and their
        source pins release NOW instead of at the match-timeout sweep.
        ``posted_before_ns`` scopes the reap to sends already posted at
        that instant: the plane is process-wide, and a send some other
        server or channel posted mid-drain must not be collateral.  A
        launched copy is never failed here — it completes on the card.
        Returns the number failed."""
        stale = []
        with self._lock:
            for uuid, t in list(self._pending.items()):
                if posted_before_ns is None \
                        or t.posted_ns < posted_before_ns:
                    stale.append(self._pending.pop(uuid))
        for t in stale:
            self._fail(t, reason)
        return len(stale)

    def _sweep_stale(self) -> None:
        """Reap posted sends whose recv never matched (peer died between
        descriptor and rendezvous): fail ONLY those transfers, releasing
        their source pins."""
        timeout = _flags.get_flag("ici_device_plane_match_timeout_s")
        cutoff = time.monotonic_ns() - int(timeout * 1e9)
        stale = []
        with self._lock:
            for uuid, t in list(self._pending.items()):
                if t.posted_ns < cutoff:
                    stale.append(self._pending.pop(uuid))
            self.match_timeouts += len(stale)
        for t in stale:
            self._fail(t, f"no matching recv within {timeout}s "
                          "(match timeout)")

    # ---- observability -------------------------------------------------
    @staticmethod
    def _annotate(t: DeviceTransfer, what: str) -> None:
        """Called for a ``traced`` transfer only: onto its own span, else
        onto the span in scope."""
        text = (f"device_plane {what} uuid={t.uuid:#x} "
                f"ici://{t.src_dev}->{t.dst_dev} {t.nbytes}B")
        if t.span is not None:
            t.span.annotate(text)
        else:
            _span.annotate_current(text)

    @staticmethod
    def _close_span(t: DeviceTransfer, error_code: int) -> None:
        span, t.span = t.span, None
        if span is not None:
            _span.end_span(span, error_code)

    def recent_transfers(self) -> List[dict]:
        """The last 64 finished transfers, their timelines newest last
        (the /ici page)."""
        return [_describe(tl) for tl in list(self._recent)]

    def pending_sends(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "transfers": self.transfers,
                "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "kernel_builds": self.kernel_builds,
                "build_failures": self.build_failures,
                "match_timeouts": self.match_timeouts,
            }
        out["pending_sends"] = self.pending_sends()
        return out


def plane() -> DevicePlane:
    return DevicePlane.instance()
