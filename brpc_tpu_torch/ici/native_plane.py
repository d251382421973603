"""Native ici:// plane: the Python control plane over the port's C++ core.

The unary hot path of an in-process ``ici://`` call (window reservation,
TRPC frame encode, queue hop, dispatch, correlation wake) runs in
``csrc/ici_native.cpp``.  Python is on the datapath only to move a device
ref that is not resident on the target rank: the relocation upcall, which
crosses at or above ``ici_device_plane_threshold`` on the device plane
(``post_send`` + ``post_recv``: one ``p2p_copy`` launch) and below it with
``mesh.device_put``, as ``IciSocket._relocate`` does.

Three pieces:

* the **device-ref registry** keeps tensors alive while their keys are in
  native custody.  A key given to native leaves custody exactly once:
  into Python (``take`` at an upcall or a response) or by the release
  upcall on a drop path;
* :class:`ServerBinding` attaches a ``Server``'s method table to a native
  listener.  Requests arrive in batches through one upcall and are
  served inline, on a tasklet or on the usercode pool, as InputMessenger
  dispatches; responses go back in batches;
* :class:`ChannelBinding` is the client side ``Channel`` uses when the
  target rank has a native listener in this process.

Order on the device: the relocation upcall returns the copy's output while
the copy may still run on the plane's stream.  Before it returns, the
upcall makes the destination device's current stream of its thread wait
for the plane's copies (``DevicePlane.order_after_copies``).  Every thread
of the port that has not entered a stream of its own shares that stream
(the device's default stream), so a handler that reads the tensor later,
on a tasklet or a pool thread, is ordered after the copy with no host
sync.  The source tensor stays pinned by its ``DeviceTransfer`` until the
copy's completion fires, though the core releases its old key as soon as
the upcall returns, and the plane's ``active_transfers()`` counts the copy
until then.
"""
from __future__ import annotations

import atexit
import ctypes
import itertools
import queue
import threading
import time as _time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ..butil import flags as _flags
from ..butil import logging as log
from ..butil import native
from ..butil.iobuf import Block, BlockRef, DEVICE, IOBuf
from ..butil.native import (IciCallOut, IciRespC, IciSegC, _ICI_BATCH_FN,
                            _ICI_RELEASE_FN, _ICI_RELOCATE_FN)
from ..rpc import errors
from ..rpc import request_context as _reqctx

_U8P = ctypes.POINTER(ctypes.c_uint8)
_reqctx_tls = _reqctx._tls
# the raw C string_at: the public wrapper is a Python frame per read
_string_at = ctypes._string_at

# call_fused returns this when the call must take the Python plane (frame
# too large, hedging configured, a dead connection's re-route): distinct
# from None, a failed call's result
FUSED_FALLTHROUGH = object()

_flags.define_flag("ici_native_att_custody", True,
                   "park ici attachment seg lists natively: handlers get a "
                   "lazily materialized zero-copy view instead of a "
                   "per-seg registry walk")

_hot = None


def _hot_modules():
    global _hot
    if _hot is None:
        from ..bthread import scheduler
        from ..rpc import fault_injection
        from . import transport
        _hot = (fault_injection, scheduler, transport)
    return _hot


_stage_hot = None


def _stage_modules():
    global _stage_hot
    if _stage_hot is None:
        from ..policy.tpu_std import _record_stage, _stage_flag
        _stage_hot = (_stage_flag, _record_stage)
    return _stage_hot


def _controller_pool():
    from ..rpc.controller import server_controller_pool
    return server_controller_pool


# ---------------------------------------------------------------------
# device-ref registry
# ---------------------------------------------------------------------

class _DevRegistry:
    """key -> tensor, alive while the key is in native custody.  Keys come
    from ``itertools.count`` and every table op is one dict operation, so
    no lock is needed; a key is written once and removed once."""

    def __init__(self):
        self._m: Dict[int, Any] = {}
        self._next = itertools.count(1).__next__

    def put(self, arr) -> int:
        key = self._next()
        self._m[key] = arr
        return key

    def peek(self, key: int):
        return self._m.get(key)

    def take(self, key: int):
        """Remove and return: Python takes custody."""
        return self._m.pop(key, None)

    def release(self, key: int) -> None:
        self._m.pop(key, None)

    def live(self) -> int:
        return len(self._m)


_registry = _DevRegistry()


def registry() -> _DevRegistry:
    return _registry


# ---------------------------------------------------------------------
# upcalls (relocation is the only Python on the datapath)
# ---------------------------------------------------------------------

_stats_lock = threading.Lock()
# relocations that crossed ranks on the device plane (one p2p_copy each),
# those that took mesh.device_put, those that failed, and the plane
# relocations of requests a server turned away before counting them
# received (the lame-duck and no-method bounces): launches no handler saw
_reloc = {"plane": 0, "device_put": 0, "failed": 0, "dropped": 0}
# the plane's relocations whose copy has not completed: a listener's stop
# waits for them (see wait_relocations)
_reloc_live: set = set()


def relocation_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_reloc)


def _reloc_done(t) -> None:
    with _stats_lock:
        _reloc_live.discard(t)


def wait_relocations(timeout: float = 10.0) -> int:
    """Block until every relocation copy launched so far has completed
    (its source pin released, the plane no longer counting it), or the
    timeout passes; returns how many are still running.  The upcall
    orders the consumer on the device and returns without waiting, so
    the completion trails the call: a listener's stop waits here."""
    with _stats_lock:
        live = list(_reloc_live)
    deadline = _time.monotonic() + timeout
    for t in live:
        t.wait(max(deadline - _time.monotonic(), 0.0))
    with _stats_lock:
        return sum(1 for t in live if t in _reloc_live)


def _relocate(key: int, target_dev: int, err: Optional[int] = None,
              err_cap: int = 0) -> int:
    """Move the tensor behind ``key`` to rank ``target_dev``; returns a NEW
    key for the moved tensor (native releases the old one), the same key
    when the rank already owns it, or 0 on failure: native fails the
    call with EINTERNAL and the reason this writes into ``err`` (a
    buffer of ``err_cap`` bytes), so the text belongs to that call.
    A fabric payload delivered host-resident (kinds 2 and 5: a CPU tensor
    over the native receive buffer, which no rank owns) takes
    ``device_put``, which copies, so the buffer may be recycled under the
    moved tensor (the JAX package detaches such a view first).
    Never raises across ctypes: an error is logged."""
    try:
        from . import device_plane as _dp
        from .mesh import IciMesh
        arr = _registry.peek(key)
        if arr is None:
            return 0
        mesh = IciMesh.default()
        src = mesh.rank_of(arr)
        if src == target_dev:
            return key                       # resident: a pure ref pass
        nbytes = int(arr.shape[0]) if arr.dim() == 1 else 0
        if nbytes and src >= 0 and _dp.eligible(nbytes, mesh, src,
                                                target_dev):
            plane = _dp.plane()
            # a refused post or a failed launch fails the call: no library
            # copy stands in for the kernel
            t = plane.post_send(arr, src, target_dev, mesh=mesh)
            t = plane.post_recv(t.uuid)
            out = t.out
            # read at a bounce (_count_bounced): the launch is accounted
            out._brpc_plane_relocated = True
            if out.is_cuda:
                plane.order_after_copies(out.device)
            with _stats_lock:
                _reloc["plane"] += 1
                _reloc_live.add(t)
            # fires at once when the copy is already complete (a CPU mesh)
            t.add_done_callback(lambda _err, t=t: _reloc_done(t))
            return _registry.put(out)
        moved = mesh.device_put(arr, target_dev)
        with _stats_lock:
            _reloc["device_put"] += 1
        return _registry.put(moved)
    except Exception as e:
        with _stats_lock:
            _reloc["failed"] += 1
        log.error("ici relocate(key=%d, dev=%d) failed: %s", key,
                  target_dev, e)
        if err and err_cap > 1:
            text = f"{type(e).__name__}: {e}".encode(
                "utf-8", "replace")[:err_cap - 1]
            ctypes.memmove(err, text + b"\0", len(text) + 1)
        return 0


def _release(key: int) -> None:
    """The core ends its custody of ``key``.  A plane relocation no
    handler took and no bounce counted (a call the core failed after its
    relocation, as a stop fails its in-flight calls) is a launch nobody
    saw: it counts as dropped here."""
    _account([_registry.peek(key)], dropped=True)
    _registry.release(key)


def _account(arrs, dropped: bool) -> None:
    """Mark each plane-relocated array in ``arrs`` accounted, once: as a
    request received, or (``dropped``) as a launch no handler saw."""
    n = 0
    for a in arrs:
        if (getattr(a, "_brpc_plane_relocated", False)
                and not getattr(a, "_brpc_plane_accounted", False)):
            a._brpc_plane_accounted = True
            n += 1
    if n and dropped:
        with _stats_lock:
            _reloc["dropped"] += n


def _attachment_arrays(att) -> list:
    if att is None:
        return []
    if isinstance(att, NativeAttachment) and att.parked:
        return [_registry.peek(key) for key, _n, _d in att._seg_meta]
    if isinstance(att, NativeAttachment) and not att._mat:
        return []                      # surrendered or disposed
    return [r.block.data for r in att._refs if r.block.kind == DEVICE]


def _count_bounced(att) -> None:
    """A request turned away before its method counted it received: count
    the plane relocations its attachment carries as dropped.  Call it
    before the attachment's custody is released."""
    _account(_attachment_arrays(att), dropped=True)


def _count_received(att) -> None:
    """A request its method counted received: its plane relocations are
    accounted, whatever later releases them."""
    _account(_attachment_arrays(att), dropped=False)


_hooks_installed = False
_hooks_lock = threading.Lock()
_relocate_cb = None
_release_cb = None
# native att-custody handle ops, bound once: (take, dispose)
_att_fns = None


def ensure_hooks() -> bool:
    """Install the relocate and release upcalls once per process, and the
    exit-time quiesce."""
    global _hooks_installed, _relocate_cb, _release_cb, _att_fns
    lib = native.load()
    if lib is None:
        return False
    with _hooks_lock:
        if not _hooks_installed:
            _relocate_cb = _ICI_RELOCATE_FN(_relocate)
            _release_cb = _ICI_RELEASE_FN(_release)
            lib.brpc_tpu_ici_set_hooks(_relocate_cb, _release_cb)
            _att_fns = (lib.brpc_tpu_ici_att_take,
                        lib.brpc_tpu_ici_att_dispose)
            atexit.register(quiesce)
            _hooks_installed = True
    return True


# open client connections, closed by quiesce
_channel_bindings: "weakref.WeakSet" = weakref.WeakSet()


def quiesce() -> None:
    """Stop every native listener and close every native connection of
    this process: parked calls fail and their threads return to Python.
    Run at exit, while the interpreter still runs threads (the core's
    registries are never torn down, so nothing else ends them)."""
    with _server_bindings_lock:
        servers = list(_server_bindings.values())
    for b in servers:
        b.stop()
    for c in list(_channel_bindings):
        c.close()


def available() -> bool:
    return native.available()


def has_listener(device_id: int) -> bool:
    lib = native.load()
    return lib is not None and \
        lib.brpc_tpu_ici_has_listener(device_id) == 1


# device_id -> ServerBinding, for what native cannot answer (dispatch mode)
_server_bindings: Dict[int, "ServerBinding"] = {}
_server_bindings_lock = threading.Lock()


def listener_dispatch_inline(device_id: int,
                             method: Optional[str] = None) -> Optional[bool]:
    """True when the in-process listener at ``device_id`` answers
    ``method`` inline on the caller's thread (a ``usercode_inline``
    server, or the C++ echo tier), False when the handler runs on a
    tasklet, None when unknown.  Fan-out issuers read it: against an
    inline answer a sub-call per tasklet buys no concurrency."""
    with _server_bindings_lock:
        b = _server_bindings.get(device_id)
    if b is None:
        return None
    if method is not None and method in b._echo_methods:
        return True
    return bool(b._server.options.usercode_inline)


# ---------------------------------------------------------------------
# IOBuf <-> (att_host, segs) marshalling
# ---------------------------------------------------------------------

_IciMesh = None


def _mesh_cls():
    global _IciMesh
    if _IciMesh is None:
        from .mesh import IciMesh
        _IciMesh = IciMesh
    return _IciMesh


def _device_index(arr) -> int:
    """The rank owning ``arr`` on the default mesh, -1 when none does (the
    core then always upcalls, and the relocation hook decides)."""
    try:
        return _mesh_cls().default().rank_of(arr)
    except Exception:
        return -1


def _append_device(buf: IOBuf, arr, nbytes: int) -> None:
    blk = Block(DEVICE, arr, size=nbytes)
    buf._refs.append(BlockRef(blk, 0, nbytes))
    buf._size += nbytes


def split_attachment(buf: IOBuf) -> Tuple[bytes, list]:
    """An attachment as the host byte stream plus the ordered segment
    descriptors, as plain tuples ``(key, nbytes, rank, is_dev)``.  Device
    blocks are registered (native custody begins); each run of host bytes
    becomes one descriptor."""
    host_parts: List[bytes] = []
    segs: list = []
    run = 0
    for i in range(buf.backing_block_num()):
        r = buf.backing_block(i)
        if r.block.kind == DEVICE:
            if run:
                segs.append((0, run, 0, 0))
                run = 0
            arr = r.block.data
            if r.offset or r.length != arr.shape[0]:
                arr = arr[r.offset:r.offset + r.length]
            segs.append((_registry.put(arr), r.length, _device_index(arr),
                         1))
        else:
            host_parts.append(bytes(r.block.host_view(r.offset, r.length)))
            run += r.length
    if run:
        segs.append((0, run, 0, 0))
    return b"".join(host_parts), segs


def fill_seg_array(segs) -> "ctypes.Array":
    """An ``(IciSegC * n)`` array from :func:`split_attachment`'s
    descriptors."""
    arr = (IciSegC * len(segs))()
    for j, sg in enumerate(segs):
        if type(sg) is tuple:
            e = arr[j]
            e.key, e.nbytes, e.dev, e.is_dev = sg
        else:
            arr[j] = sg
    return arr


def build_attachment_from_c(att_host: bytes, segs_p, nsegs: int) -> IOBuf:
    """An IOBuf from a C seg array, taking every device key.  Native
    clears its seg list when the upcall returns, so on a failure midway
    the keys not yet walked are released before the raise."""
    buf = IOBuf()
    off = 0
    take = _registry.take
    i = 0
    try:
        while i < nsegs:
            s = segs_p[i]
            n = s.nbytes
            if s.is_dev:
                arr = take(s.key)
                if arr is None:
                    raise KeyError(f"ici device ref {s.key} missing")
                _append_device(buf, arr, n)
            else:
                buf.append(att_host[off:off + n])
                off += n
            i += 1
    except BaseException:
        for j in range(i + 1, nsegs):
            s = segs_p[j]
            if s.is_dev:
                _registry.release(s.key)
        raise
    return buf


class NativeAttachment(IOBuf):
    """A zero-copy attachment view backed by native custody.

    The device-seg list stays parked in the core's attachment table under
    ``_h``; the keys stay in the registry.  The handle leaves custody
    exactly once, by whichever comes first:

    * pass-through: ``cntl.response_attachment = view`` hands the handle
      back to native in the response (the echo shape: no Python walk);
    * materialization: any structural touch (``backing_block_num``,
      ``to_bytes``, appending it to another IOBuf) takes the keys into
      Python and builds real DEVICE blocks;
    * dispose: the server Controller's pool recycle, or ``__del__``, has
      native release every parked key.

    ``len()``, ``size()`` and ``empty()`` answer from the descriptors
    without materializing."""

    __slots__ = ("_h", "_total", "_seg_meta", "_mat")

    def __init__(self, handle: int, total: int, seg_meta: tuple):
        # IOBuf.__init__ is not called: _refs/_size stay unset until the
        # first structural touch inflates them through __getattr__
        self._h = handle
        self._total = total
        self._seg_meta = seg_meta      # ((key, nbytes, rank), ...)
        self._mat = False

    def __getattr__(self, name):
        if name in ("_refs", "_size"):
            self._materialize()
            return object.__getattribute__(self, name)
        raise AttributeError(name)

    def _materialize(self) -> None:
        IOBuf.__init__(self)
        self._mat = True
        h = self._h
        if not h:
            return                     # surrendered or disposed: empty
        self._h = 0
        for arr, nbytes in self._take_parked(h):
            _append_device(self, arr, nbytes)

    def _take_parked(self, h: int) -> list:
        """Consume the parked entry ``h`` and its keys: ``[(tensor,
        nbytes), ...]``.  On a failure every key not yet taken is released
        before the raise."""
        fns = _att_fns
        metas = self._seg_meta
        if fns is None or fns[0](h) < 0:
            for key, _n, _d in metas:
                _registry.release(key)
            raise KeyError(f"ici native att handle {h} missing")
        out = []
        for i, (key, nbytes, _dev) in enumerate(metas):
            arr = _registry.take(key)
            if arr is None:
                for k2, _n2, _d2 in metas[i + 1:]:
                    _registry.release(k2)
                raise KeyError(f"ici device ref {key} missing")
            out.append((arr, nbytes))
        return out

    def __len__(self) -> int:
        return self._total if not self._mat else self._size

    def size(self) -> int:
        return self.__len__()

    def empty(self) -> bool:
        return self.__len__() == 0

    def __repr__(self) -> str:
        if self._mat:
            return IOBuf.__repr__(self)
        return (f"NativeAttachment(size={self._total}, "
                f"handle={self._h:#x}, lazy)")

    @property
    def parked(self) -> bool:
        """True while the seg list is still in native custody."""
        return not self._mat and bool(self._h)

    def take_segments(self) -> list:
        """Take the parked segs into Python as ``(tensor, nbytes)`` pairs
        without building IOBuf blocks; the view reads as an empty IOBuf
        afterwards."""
        if self._mat or not self._h:
            raise ValueError(
                "take_segments: view already materialized or exited")
        IOBuf.__init__(self)
        self._mat = True
        h = self._h
        self._h = 0
        return self._take_parked(h)

    def _surrender_native(self) -> int:
        """Hand the parked entry back to native (the response pass-through):
        returns the handle and forgets it, 0 when there is none."""
        if self._mat:
            return 0
        h = self._h
        self._h = 0
        return h

    def _dispose_native(self) -> None:
        """A drop path: native releases every parked key.  Idempotent."""
        h = self._h
        if h:
            self._h = 0
            fns = _att_fns
            if fns is not None:
                fns[1](h)

    def __del__(self):
        try:
            self._dispose_native()
        except Exception:
            pass


class ResponseAttachment(NativeAttachment):
    """The Controller's default response attachment once this module is
    loaded: a plain IOBuf until a whole, untouched :class:`NativeAttachment`
    is appended while it is still empty (the echo idiom
    ``cntl.response_attachment.append(cntl.request_attachment)``).  That
    append adopts the parked handle instead of materializing it, so the
    response passes it back with no Python walk, as the assignment idiom
    does."""

    __slots__ = ()

    def __init__(self):
        IOBuf.__init__(self)
        self._h = 0
        self._total = 0
        self._seg_meta = ()
        self._mat = True

    def append(self, data) -> None:
        if (self._mat and isinstance(data, NativeAttachment)
                and not data._mat and data._h and not self._refs):
            self._h = data._h
            data._h = 0
            self._total = data._total
            self._seg_meta = data._seg_meta
            self._mat = False
            del self._refs, self._size
            return
        IOBuf.append(self, data)


def _install_response_attachment_factory() -> None:
    from ..rpc.controller import Controller
    vars(Controller)["response_attachment"].factory = ResponseAttachment


_install_response_attachment_factory()


def _seg_meta_from_req(r, nsegs: int):
    """``((key, nbytes, rank), ...)`` and the total of a request or
    out-block that carries a handle."""
    if nsegs == 1:
        n = r.seg0_nbytes
        return ((r.seg0_key, n, r.seg0_dev),), n
    segs_p = r.segs
    total = 0
    meta = []
    for i in range(nsegs):
        s = segs_p[i]
        meta.append((s.key, s.nbytes, s.dev))
        total += s.nbytes
    return tuple(meta), total


def att_table_live() -> int:
    """Parked native attachment entries; 0 without the core."""
    lib = native.load()
    return int(lib.brpc_tpu_ici_att_count()) if lib is not None else 0


def _dispose_view(att) -> None:
    if att is not None and isinstance(att, NativeAttachment):
        att._dispose_native()


# ---------------------------------------------------------------------
# server binding
# ---------------------------------------------------------------------

class _RespondCollector:
    """Per-upcall response accumulator: each ``done()`` that fires while
    its delivery upcall is open parks its response here, and one
    ``brpc_tpu_ici_respond_batch`` crossing flushes them when the upcall
    closes.  A later ``done()`` responds as a batch of one."""

    __slots__ = ("_binding", "_lock", "_items", "_open")

    def __init__(self, binding: "ServerBinding"):
        self._binding = binding
        self._lock = threading.Lock()
        self._items: List[tuple] = []
        self._open = True

    def add(self, item: tuple) -> bool:
        with self._lock:
            if not self._open:
                return False
            self._items.append(item)
            return True

    def close_and_flush(self) -> None:
        with self._lock:
            self._open = False
            items, self._items = self._items, []
        if items:
            self._binding._respond_flush(items)


def _release_request_custody(lib, r) -> None:
    """Release what one delivered request holds in native custody: its
    parked attachment handle, or its device keys."""
    if r.att_handle:
        lib.brpc_tpu_ici_att_dispose(r.att_handle)
    else:
        for j in range(r.nsegs):
            sg = r.segs[j]
            if sg.is_dev:
                _registry.release(sg.key)


class _BatchUpcall:
    """The target of a listener's batched upcall.  It holds the binding
    while the listener is open and drops it at the stop, so a stopped
    listener keeps no Server (and no pool on the card) alive.  The C
    callback object stays alive for the process (a drainer may still be
    inside it when the listener stops); a request delivered after the
    stop only has its custody released (its token was purged)."""

    __slots__ = ("binding", "lib")

    def __init__(self, binding, lib):
        self.binding = binding
        self.lib = lib

    def __call__(self, reqs, n):
        b = self.binding
        if b is not None:
            b._on_batch(reqs, n)
            return
        for i in range(n):
            try:
                _release_request_custody(self.lib, reqs[i])
            except Exception:
                pass


# every listener's C callback, kept for the process (see _BatchUpcall)
_upcalls: List[Any] = []


class ServerBinding:
    """The native listener of one rank, dispatching into a ``Server``'s
    method table (methods registered with :meth:`register_native_echo`
    are answered in C++).

    A response item is ``(token, err, err_text, payload, att_host, segs,
    post, retry_after_ms, att_handle)``; ``post`` (the drain gate's
    accounting) runs after the response crossed back to native, so
    ``inflight_requests()`` never reads zero while an executed request's
    response is still in Python."""

    def __init__(self, server, device_id: int):
        lib = native.load_or_raise()
        ensure_hooks()
        self._lib = lib
        self._server = server
        self.device_id = device_id
        self._echo_methods: set = set()
        self._peer_eps: Dict[int, Any] = {}
        self._tenant_names: Dict[bytes, str] = {}
        self._methods: Dict[bytes, tuple] = {}
        self._tls = threading.local()
        self._upcall = _BatchUpcall(self, lib)
        cb = _ICI_BATCH_FN(self._upcall)
        _upcalls.append(cb)
        # the handler rides the listen call: a racing caller never sees a
        # half-initialized listener
        h = lib.brpc_tpu_ici_listen_batch(device_id, cb)
        if h == 0:
            raise OSError(errors.EINVAL,
                          f"ici://{device_id} already listening (native)")
        self._handle = h
        # read once, at bind
        self._att_custody = bool(_flags.get_flag("ici_native_att_custody"))
        lib.brpc_tpu_ici_set_att_handles(h, 1 if self._att_custody else 0)
        self._stage_flag, self._record_stage = _stage_modules()
        self._pool = _controller_pool()
        with _server_bindings_lock:
            _server_bindings[device_id] = self

    def register_native_echo(self, full_method: str) -> None:
        self._lib.brpc_tpu_ici_register_echo(self._handle,
                                             full_method.encode())
        self._echo_methods.add(full_method)

    def stop(self) -> None:
        """Close the listener (its pending calls fail), then wait for the
        relocation copies launched so far: the stop returns with no
        source pinned by a copy of this door's calls."""
        if self._handle:
            self._lib.brpc_tpu_ici_unlisten(self._handle)
            self._handle = 0
            self._upcall.binding = None
            with _server_bindings_lock:
                if _server_bindings.get(self.device_id) is self:
                    del _server_bindings[self.device_id]
            left = wait_relocations()
            if left:
                log.error("ici://%d stopped with %d relocation copies "
                          "still running", self.device_id, left)

    def requests(self) -> int:
        """Requests this listener received (native count)."""
        if not self._handle:
            return 0
        return int(self._lib.brpc_tpu_ici_requests(self._handle))

    def batch_stats(self) -> Tuple[int, int, int]:
        """(upcalls, requests delivered, largest batch)."""
        u = ctypes.c_uint64()
        r = ctypes.c_uint64()
        m = ctypes.c_uint64()
        self._lib.brpc_tpu_ici_batch_stats(
            self._handle, ctypes.byref(u), ctypes.byref(r),
            ctypes.byref(m))
        return u.value, r.value, m.value

    # ---- the batched upcall ------------------------------------------
    def _on_batch(self, reqs, n):
        """One crossing for up to 64 requests (the core's kBatchMax).
        Inline servers serve each here and flush the responses in one
        crossing; other modes fan out to tasklets or the usercode pool,
        where each request of the batch counts queued on its own."""
        try:
            inline = bool(self._server.options.usercode_inline)
            collector = _RespondCollector(self) if inline and n > 1 \
                else None
            try:
                for i in range(n):
                    # a failure of request i answers its own token
                    # EINTERNAL and releases its own custody: the rest of
                    # the batch is served
                    r = reqs[i]
                    try:
                        self._dispatch(r, inline, collector)
                    except Exception as e:
                        self._batch_request_failed(r, e)
            finally:
                if collector is not None:
                    collector.close_and_flush()
        except Exception as e:       # never raise across ctypes
            log.error("ici batch upcall failed: %s", e, exc_info=True)

    def _method(self, mkey: bytes):
        """The dispatch tuple ``(full, fn, request_cls, response_cls,
        status)`` of the method named ``mkey``, resolved once per listener
        (services are fixed once the server started); None when the
        server has no descriptor for it (a miss is not cached)."""
        full = mkey.decode()
        md = self._server.find_method(full)
        if md is None:
            return None
        ent = self._methods[mkey] = (full, md.fn, md.request_cls,
                                     md.response_cls,
                                     self._server.method_status(full))
        return ent

    def _dispatch(self, r, inline, collector) -> None:
        """Take one delivered request out of the upcall's structs (native
        clears them when the upcall returns), then serve it here (an
        inline server), on the usercode pool or on a tasklet."""
        token = r.token
        mkey = r.method
        ent = self._methods.get(mkey)
        if ent is None:
            ent = self._method(mkey)
        nsegs = r.nsegs
        ahl = r.att_host_len
        attachment = None
        if nsegs or ahl:
            ah = r.att_handle
            if ah:
                if nsegs == 1:          # the dominant shape, inline
                    total = r.seg0_nbytes
                    attachment = NativeAttachment(
                        ah, total, ((r.seg0_key, total, r.seg0_dev),))
                else:
                    meta, total = _seg_meta_from_req(r, nsegs)
                    attachment = NativeAttachment(ah, total, meta)
            else:
                # the registry takes happen here, inside the upcall
                att_host = _string_at(r.att_host, ahl) if ahl else b""
                try:
                    attachment = build_attachment_from_c(att_host, r.segs,
                                                         nsegs)
                except KeyError as e:
                    self._respond_one(token, errors.EINTERNAL, str(e),
                                      collector)
                    return
        tb = r.tenant
        # decoded before any gate or pool acquire: a malformed tenant fails
        # where nothing needs rolling back
        adm_meta = (r.priority, self._tenant(tb) if tb else "",
                    r.deadline_left_ms)
        payload = _string_at(r.payload, r.payload_len) \
            if r.payload_len else b""
        if inline:
            self._process(token, mkey, ent, payload, attachment, r.log_id,
                          r.peer_dev, r.recv_ns, collector, adm_meta)
            return
        server = self._server
        pool = server.usercode_pool
        full = ent[0] if ent is not None else mkey.decode()
        if pool is not None:
            server.on_usercode_queued()
            reg = server._isolated.get(full) if server._isolated else None
            try:
                if reg is not None:
                    pool.submit(self._run_isolated, token, full, payload,
                                attachment, reg, adm_meta, r.recv_ns)
                else:
                    pool.submit(self._run_usercode, token, mkey, ent,
                                payload, attachment, r.log_id, r.peer_dev,
                                r.recv_ns, adm_meta)
            except RuntimeError:
                server.on_usercode_done()
                if reg is not None:
                    # the isolation workers are gone too: bounce
                    # retryable, as the drain does
                    _count_bounced(attachment)
                    _dispose_view(attachment)
                    self._respond_one(token, errors.ELOGOFF,
                                      "server stopping")
                else:
                    # the pool shut down mid-stop: serve here
                    self._process(token, mkey, ent, payload, attachment,
                                  r.log_id, r.peer_dev, r.recv_ns, None,
                                  adm_meta)
        else:
            from ..bthread import scheduler
            scheduler.start_background(
                self._process, token, mkey, ent, payload, attachment,
                r.log_id, r.peer_dev, r.recv_ns, None, adm_meta,
                name=f"ici-req:{full}")

    def _tenant(self, tb: Optional[bytes]) -> str:
        if not tb:
            return ""
        tenant = self._tenant_names.get(tb)
        if tenant is None:
            tenant = tb.decode()
            # wire input: a caller cycling tenant names cannot grow the
            # cache without bound
            if len(self._tenant_names) < 1024:
                self._tenant_names[tb] = tenant
        return tenant

    def _batch_request_failed(self, r, e) -> None:
        """Answer this token EINTERNAL and release this request's custody
        (a dispose of a handle that already left is a table miss)."""
        log.error("ici batch request failed: %s", e, exc_info=True)
        try:
            _release_request_custody(self._lib, r)
        except Exception:
            pass
        try:
            self._respond_one(r.token, errors.EINTERNAL,
                              f"{type(e).__name__}: {e}")
        except Exception:
            pass

    def _run_usercode(self, token, mkey, ent, payload, attachment, log_id,
                      peer_dev, recv_ns, adm_meta) -> None:
        try:
            self._process(token, mkey, ent, payload, attachment, log_id,
                          peer_dev, recv_ns, None, adm_meta)
        finally:
            self._server.on_usercode_done()

    def _run_isolated(self, token, full, payload, attachment, reg,
                      adm_meta=None, recv_ns=0) -> None:
        """An isolated method on a backup thread: the gates (admission
        included), the pool round trip (payload bytes in, response bytes
        out), attachment custody, the response."""
        server = self._server
        try:
            if server._draining:
                _count_bounced(attachment)
                _dispose_view(attachment)
                self._respond_one(token, errors.ELOGOFF,
                                  "server is draining (lame duck)")
                return
            _count_received(attachment)
            pri_wire, tenant, ddl = adm_meta or (0, "", 0)
            adm = server.admission
            if adm is not None:
                from ..rpc import admission as admission_mod

                def _admitted(queued_us: int) -> None:
                    # the budget shrank while queued
                    left = max(ddl - queued_us // 1000, 1) if ddl else 0
                    self._isolated_admitted(token, full, payload,
                                            attachment, reg, left)

                def _shed(code: int, text: str, retry_after: int) -> None:
                    _dispose_view(attachment)
                    self._respond_one(token, code, text,
                                      retry_after=retry_after)

                adm.submit(
                    priority=(pri_wire - 1) if pri_wire else None,
                    tenant=tenant, deadline_left_ms=ddl or None,
                    recv_us=(recv_ns // 1000) if recv_ns else 0,
                    try_enter=admission_mod.server_method_gate(server,
                                                               None),
                    run=_admitted, shed=_shed)
                return
            if not server.on_request_in():
                _dispose_view(attachment)
                self._respond_one(token, errors.ELIMIT,
                                  "server max_concurrency reached")
                return
            self._isolated_admitted(token, full, payload, attachment, reg,
                                    ddl)
        finally:
            server.on_usercode_done()

    def _isolated_admitted(self, token, full, payload, attachment, reg,
                           deadline_left_ms) -> None:
        server = self._server
        _src, att_mode = reg
        start_ns = _time.monotonic_ns()
        pool = server.usercode_pool
        try:
            if pool is None:
                raise RuntimeError("usercode pool stopped")
            resp = pool.call_isolated(
                full, payload,
                timeout=(deadline_left_ms / 1000.0)
                if deadline_left_ms else None)
        except TimeoutError:
            _dispose_view(attachment)
            self._respond_item(
                (token, errors.ERPCTIMEDOUT,
                 f"isolated handler exceeded deadline "
                 f"({deadline_left_ms}ms)".encode(), b"", b"", (),
                 (None, errors.ERPCTIMEDOUT, 0, server), 0, 0))
            return
        except Exception as e:
            _dispose_view(attachment)
            self._respond_item(
                (token, errors.EINTERNAL,
                 f"{type(e).__name__}: {e}".encode(), b"", b"", (),
                 (None, errors.EINTERNAL, 0, server), 0, 0))
            return
        latency_us = (_time.monotonic_ns() - start_ns) // 1000
        pass_h = 0
        att_host = b""
        segs = ()
        if attachment is not None:
            if isinstance(attachment, NativeAttachment) \
                    and not attachment._mat:
                if att_mode == "echo":
                    pass_h = attachment._surrender_native()
                else:
                    attachment._dispose_native()
            elif att_mode == "echo" and attachment.backing_block_num():
                att_host, segs = split_attachment(attachment)
        self._respond_item((token, 0, b"", resp, att_host, segs,
                            (None, 0, latency_us, server), 0, pass_h))

    # ---- the gates and the handler ---------------------------------
    def _process(self, token, mkey, ent, payload, attachment, log_id,
                 peer_dev, recv_ns, collector, adm_meta) -> None:
        """The gates (the lame duck, the method, then admission or the
        concurrency limits), then the handler."""
        server = self._server
        stages = self._stage_flag.value == "on"
        if stages and recv_ns:
            q_us = (_time.monotonic_ns() - recv_ns) // 1000
            self._record_stage("queue", max(q_us, 0), None)
        if server._draining:
            # the native door stays open through the grace window so calls
            # in flight finish; new ones bounce with retryable ELOGOFF
            _count_bounced(attachment)
            _dispose_view(attachment)
            self._respond_one(token, errors.ELOGOFF,
                              "server is draining (lame duck)", collector)
            return
        if ent is None:
            _count_bounced(attachment)
            _dispose_view(attachment)
            self._respond_one(token, errors.ENOMETHOD,
                              f"no method {mkey.decode()}", collector)
            return
        status = ent[4]
        if status is not None:
            status.received << 1
        _count_received(attachment)
        adm = server.admission
        if adm is not None:
            # the wire and loopback planes' decision, in front of the same
            # gates
            pri_wire, tenant, deadline_left = adm_meta
            from ..rpc import admission as admission_mod

            def _admitted(queued_us: int) -> None:
                if stages and queued_us:
                    self._record_stage("queue", queued_us, None)
                self._execute(token, ent, payload, attachment, log_id,
                              peer_dev, collector, adm_meta)

            def _shed(code: int, text: str, retry_after: int) -> None:
                _dispose_view(attachment)
                self._respond_one(token, code, text, collector,
                                  retry_after=retry_after)

            adm.submit(
                priority=(pri_wire - 1) if pri_wire else None,
                tenant=tenant, deadline_left_ms=deadline_left or None,
                recv_us=(recv_ns // 1000) if recv_ns else 0,
                try_enter=admission_mod.server_method_gate(server, status),
                run=_admitted, shed=_shed)
            return
        if not server.on_request_in():
            _dispose_view(attachment)
            self._respond_one(token, errors.ELIMIT,
                              "server max_concurrency reached", collector)
            return
        if status is not None and not status.on_requested():
            server.on_request_out()
            _dispose_view(attachment)
            self._respond_one(token, errors.ELIMIT,
                              f"{ent[0]} concurrency limit", collector)
            return
        self._execute(token, ent, payload, attachment, log_id, peer_dev,
                      collector, adm_meta)

    def _execute(self, token, ent, payload, attachment, log_id, peer_dev,
                 collector, adm_meta) -> None:
        """The gates are held: controller setup, parse and invoke (the
        completion is :class:`_Done`)."""
        full, fn, request_cls, response_cls, status = ent
        server = self._server
        stages = self._stage_flag.value == "on"
        cntl = self._pool.acquire()
        d = cntl.__dict__
        if log_id:
            d["log_id"] = log_id
        d["server"] = server
        ep = self._peer_eps.get(peer_dev)
        d["remote_side"] = ep if ep is not None \
            else self._peer_endpoint(peer_dev)
        pri_wire, tenant, ddl = adm_meta
        has_meta = False
        if pri_wire:
            d["priority"] = pri_wire - 1
            has_meta = True
        if tenant:
            d["tenant"] = tenant
            has_meta = True
        if ddl:
            d["deadline_left_ms"] = ddl
            has_meta = True
        if attachment is not None:
            d["request_attachment"] = attachment
        start_ns = _time.monotonic_ns()
        try:
            request = request_cls()
            request.ParseFromString(payload)
        except Exception as e:
            cntl._maybe_recycle()
            item = (token, errors.EREQUEST,
                    f"fail to parse request: {e}".encode(), b"", b"", (),
                    (status, errors.EREQUEST, 0, server), 0, 0)
            if collector is None or not collector.add(item):
                self._respond_item(item)
            return
        if stages:
            self._record_stage(
                "parse", (_time.monotonic_ns() - start_ns) // 1000, None)
        response = response_cls()
        fd = _Done(self, token, cntl, response, status, start_ns, collector,
                   stages)
        d["_server_done"] = fd         # Controller.send_response
        try:
            # the handler runs under its request's context (request_context
            # .scope's): installed only where it matters, when the request
            # carries admission meta or an outer inline context must be
            # masked for this handler's own calls
            prev_ctx = getattr(_reqctx_tls, "ctx", None)
            if has_meta or prev_ctx is not None:
                _reqctx_tls.ctx = _reqctx.InboundContext(
                    d.get("priority"), d.get("tenant", ""), ddl) \
                    if has_meta else None
                try:
                    fn(cntl, request, response, fd)
                finally:
                    _reqctx_tls.ctx = prev_ctx
            else:
                fn(cntl, request, response, fd)
        except Exception as e:
            log.error("ici method %s raised: %s", full, e, exc_info=True)
            if not fd.called:
                cntl.set_failed(errors.EINTERNAL,
                                f"{type(e).__name__}: {e}")
                fd()

    def _peer_endpoint(self, peer_dev: int):
        ep = self._peer_eps.get(peer_dev)
        if ep is None:
            from .mesh import IciMesh
            ep = self._peer_eps[peer_dev] = \
                IciMesh.default().endpoint(peer_dev)
        return ep

    # ---- batched write-back ----------------------------------------------
    def _respond_one(self, token, err, text, collector=None,
                     post=None, retry_after: int = 0) -> None:
        item = (token, err,
                text.encode() if isinstance(text, str) else (text or b""),
                b"", b"", (), post, retry_after, 0)
        if collector is None or not collector.add(item):
            self._respond_item(item)

    @staticmethod
    def _run_post(post) -> None:
        if post is None:
            return
        status, perr, lat, server = post
        if status is not None:
            status.on_responded(perr, lat)
        server.on_request_out()

    def _respond_item(self, item) -> None:
        """One response through a per-thread reused ``(IciRespC * 1)``
        (native copies everything during the call); its ``post`` runs
        after the crossing."""
        tls = self._tls.__dict__
        arr = tls.get("resp1")
        if arr is None:
            arr = tls["resp1"] = (IciRespC * 1)()
        token, err, err_text, payload, att_host, segs, post, \
            retry_after, att_handle = item
        e = arr[0]
        e.token = token
        e.err = err
        e.err_text = err_text or None
        e.retry_after_ms = retry_after
        e.att_handle = att_handle
        if payload:
            e.data = ctypes.cast(payload, _U8P)
            e.len = len(payload)
        else:
            e.data = None
            e.len = 0
        if att_host:
            e.att_host = ctypes.cast(att_host, _U8P)
            e.att_host_len = len(att_host)
        else:
            e.att_host = None
            e.att_host_len = 0
        seg_arr = fill_seg_array(segs) if segs else None
        e.segs = seg_arr
        e.nsegs = len(segs) if segs else 0
        if self._stage_flag.value == "on":
            t0 = _time.monotonic_ns()
            self._lib.brpc_tpu_ici_respond_batch(arr, 1)
            self._record_stage("write",
                               (_time.monotonic_ns() - t0) // 1000, None)
        else:
            self._lib.brpc_tpu_ici_respond_batch(arr, 1)
        del seg_arr, payload, att_host, err_text   # alive across the call
        self._run_post(post)

    def _respond_flush(self, items) -> None:
        """One ``brpc_tpu_ici_respond_batch`` crossing for ``items``; seg
        custody moves to native, which releases it on every drop path.
        Each item's ``post`` runs after the crossing."""
        n = len(items)
        arr = (IciRespC * n)()
        keep = []
        for i, (token, err, err_text, payload, att_host, segs, _post,
                retry_after, att_handle) in enumerate(items):
            e = arr[i]
            e.token = token
            e.err = err
            e.retry_after_ms = retry_after
            e.att_handle = att_handle
            if err_text:
                e.err_text = err_text
                keep.append(err_text)
            if payload:
                e.data = ctypes.cast(payload, _U8P)
                e.len = len(payload)
                keep.append(payload)
            if att_host:
                e.att_host = ctypes.cast(att_host, _U8P)
                e.att_host_len = len(att_host)
                keep.append(att_host)
            if segs:
                seg_arr = fill_seg_array(segs)
                e.segs = seg_arr
                e.nsegs = len(segs)
                keep.append(seg_arr)
        if self._stage_flag.value == "on":
            t0 = _time.monotonic_ns()
            self._lib.brpc_tpu_ici_respond_batch(arr, n)
            # batched, the write stage is the shared crossing
            w_us = (_time.monotonic_ns() - t0) // 1000
            for _ in range(n):
                self._record_stage("write", w_us, None)
        else:
            self._lib.brpc_tpu_ici_respond_batch(arr, n)
        del keep
        for it in items:
            self._run_post(it[6])


class _Done:
    """A request's completion: response encode, attachment custody exit
    (pass-through or split), the write-back and the pool recycle, with the
    drain gate's accounting packed into the item so it runs after the
    crossing.  Idempotent."""

    __slots__ = ("binding", "token", "cntl", "response", "status",
                 "start_ns", "collector", "stages", "called")

    def __init__(self, binding, token, cntl, response, status, start_ns,
                 collector, stages):
        self.binding = binding
        self.token = token
        self.cntl = cntl
        self.response = response
        self.status = status
        self.start_ns = start_ns
        self.collector = collector
        self.stages = stages
        self.called = False

    def __call__(self) -> None:
        if self.called:
            return
        self.called = True
        b = self.binding
        cntl = self.cntl
        t_done = _time.monotonic_ns()
        latency_us = (t_done - self.start_ns) // 1000
        stages = self.stages
        if stages:
            b._record_stage("handler", latency_us, None)
        d = cntl.__dict__
        if d.get("_session_data") is not None:
            cntl._release_session_data()
        err = cntl.error_code_
        status = self.status
        server = b._server
        if err:
            text = cntl.error_text_
            item = (self.token, err,
                    text.encode() if isinstance(text, str)
                    else (text or b""), b"", b"", (),
                    (status, err, latency_us, server),
                    cntl.retry_after_ms or 0, 0)
        else:
            resp_att = d.get("response_attachment")
            pass_h = 0
            att_host = b""
            segs = ()
            if resp_att is not None:
                if isinstance(resp_att, NativeAttachment) \
                        and not resp_att._mat:
                    pass_h = resp_att._h
                    resp_att._h = 0
                if not pass_h and resp_att.backing_block_num():
                    att_host, segs = split_attachment(resp_att)
            item = (self.token, 0, b"", self.response.SerializeToString(),
                    att_host, segs, (status, 0, latency_us, server),
                    0, pass_h)
            if stages:
                b._record_stage(
                    "encode", (_time.monotonic_ns() - t_done) // 1000,
                    None)
        coll = self.collector
        if coll is None or not coll.add(item):
            b._respond_item(item)
        # custody exits: a request view the handler ignored disposes here
        # (a surrendered, adopted or materialized view holds no handle)
        fns = _att_fns
        for name in ("request_attachment", "response_attachment"):
            ra = d.pop(name, None)
            if ra is not None and isinstance(ra, NativeAttachment):
                h = ra._h
                if h:
                    ra._h = 0
                    if fns is not None:
                        fns[1](h)
        pool = d.get("_recycle_pool")
        if pool is not None:
            pool.release(cntl)


# ---------------------------------------------------------------------
# channel binding
# ---------------------------------------------------------------------

class ChannelBinding:
    """The client half: one native connection, with its credit window, to
    the in-process native listener of rank ``remote_dev``."""

    FUSED_FALLTHROUGH = FUSED_FALLTHROUGH

    def __init__(self, remote_dev: int, local_dev: Optional[int] = None,
                 window_bytes: int = 0):
        lib = native.load_or_raise()
        ensure_hooks()
        from .mesh import IciMesh
        mesh = IciMesh.default()
        if local_dev is None:
            local_dev = (remote_dev + 1) % mesh.size
        self._lib = lib
        self.local_dev = local_dev
        self.remote_dev = remote_dev
        self.window_bytes = window_bytes if window_bytes > 0 else (4 << 20)
        self.remote_side = mesh.endpoint(remote_dev)
        self._names: Dict[str, bytes] = {}
        self._tenants: Dict[str, bytes] = {}
        self._tls = threading.local()
        self._att_custody = bool(_flags.get_flag("ici_native_att_custody"))
        self._call = lib.brpc_tpu_ici_call4 if self._att_custody \
            else lib.brpc_tpu_ici_call3
        self._free = lib.brpc_tpu_buf_free
        # sync calls take call_fused (one code path: context, screens,
        # call, error tails); async calls the unfused chain in Channel.
        # Off only to hold the two against each other
        self._fused = True
        self._hot = None
        from ..rpc import span as _span_mod
        self._rpcz_flag = _span_mod._rpcz_flag
        self._start_span = _span_mod.maybe_start_client_span
        self._end_span = _span_mod.end_client_span
        h = lib.brpc_tpu_ici_connect(local_dev, remote_dev, window_bytes)
        if h == 0:
            raise ConnectionRefusedError(
                f"no native listener at ici://{remote_dev}")
        self._handle = h
        _channel_bindings.add(self)

    def close(self) -> None:
        if self._handle:
            self._lib.brpc_tpu_ici_close(self._handle)
            self._handle = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def window_left(self) -> int:
        return self._lib.brpc_tpu_ici_window_left(self._handle)

    def call(self, full_name: str, cntl, request: Any,
             response_cls: Optional[type] = None):
        """One unary call on the native datapath.  Fills ``cntl``; returns
        the parsed response (the payload bytes when ``response_cls`` is
        None), or None on failure."""
        _fi = self._hot[0] if self._hot is not None else _hot_modules()[0]
        # fault injection reaches this plane with the Python plane's
        # semantics: DROP waits out the deadline, ERROR severs the
        # connection (later calls on it fail until the channel re-routes)
        injector = _fi.active()
        if injector is not None:
            action = injector.decide(self)
            if action == _fi.DROP:
                tms = cntl.timeout_ms
                _time.sleep((tms / 1000.0) if tms and tms > 0 else 60.0)
                cntl.set_failed(errors.ERPCTIMEDOUT
                                if tms and tms > 0 else errors.EFAILEDSOCKET,
                                "rpc timeout (injected drop)")
                return None
            if action == _fi.ERROR:
                cntl.set_failed(errors.EFAILEDSOCKET, "injected fault")
                self.close()
                return None
        return self._issue(full_name, cntl, request, response_cls)

    def _issue(self, full_name, cntl, request, response_cls):
        hot = self._hot
        if hot is None:
            hot = self._hot = _hot_modules()
        _fi, scheduler, _t = hot
        t0 = _time.monotonic_ns()
        try:
            req = request.SerializeToString()
        except AttributeError:
            req = bytes(request) if request is not None else b""
        tls = self._tls.__dict__
        req_att = cntl.__dict__.get("request_attachment")
        att_host = b""
        seg_arr = None
        nseg = 0
        dev_bytes = 0
        if req_att is not None and len(req_att):
            fast = None
            if type(req_att) is IOBuf:
                refs = req_att._refs
                if len(refs) == 1:
                    ref = refs[0]
                    blk = ref.block
                    if (blk.kind == DEVICE and not ref.offset
                            and ref.length == blk.size):
                        fast = (blk.data, ref.length)
            if fast is not None:
                # the dominant shape, one whole device block: a registry
                # put and a reused one-seg array, no split
                arr, nbytes = fast
                seg_arr = tls.get("seg1")
                if seg_arr is None:
                    seg_arr = tls["seg1"] = (IciSegC * 1)()
                e = seg_arr[0]
                e.dev = _device_index(arr)
                e.key = _registry.put(arr)
                e.nbytes = nbytes
                e.is_dev = 1
                nseg = 1
                dev_bytes = nbytes
            else:
                att_host, segs = split_attachment(req_att)
                if segs:
                    seg_arr = fill_seg_array(segs)
                    nseg = len(segs)
                    for sg in segs:
                        if sg[3]:
                            dev_bytes += sg[1]
        out = tls.get("out")
        if out is None:
            out = tls["out"] = IciCallOut()
            tls["out_ref"] = ctypes.byref(out)
        name_b = self._names.get(full_name)
        if name_b is None:
            name_b = self._names[full_name] = full_name.encode()
        # timeout_ms <= 0 means no deadline, on both sides
        tms = cntl.timeout_ms
        timeout_us = int(tms * 1000) if tms is not None and tms > 0 else 0
        # admission meta rides the native frame: the wire-encoded
        # priority (0 = unset), the tenant and this try's budget
        pri_wire = cntl.priority + 1 if cntl.priority is not None else 0
        tenant = cntl.tenant
        tenant_b = None
        if tenant:
            tenant_b = self._tenants.get(tenant)
            if tenant_b is None:
                tenant_b = self._tenants[tenant] = tenant.encode()
        # the call can park on a C condvar (a Python handler): a tasklet
        # worker notes itself blocked so the handler's tasklet can run
        blocked = getattr(scheduler._tls, "group", None) is not None
        if blocked:
            scheduler.note_worker_blocked()
        try:
            rc = self._call(
                self._handle, name_b, req or None, len(req),
                att_host or None, len(att_host), seg_arr, nseg, timeout_us,
                pri_wire, tenant_b,
                int(tms) if tms is not None and tms > 0 else 0,
                tls["out_ref"])
        finally:
            if blocked:
                scheduler.note_worker_unblocked()
        resp_p = out.resp
        att_p = out.att
        segs_p0 = out.segs
        err_p = out.err_text
        try:
            cntl.remote_side = self.remote_side
            nsegs = out.nsegs
            if rc != 0:
                if not self._att_custody:
                    # an error response's segs are released here (call4
                    # releases them natively)
                    for i in range(nsegs):
                        if out.segs[i].is_dev and out.segs[i].key:
                            _registry.release(out.segs[i].key)
                text = _string_at(err_p, -1).decode() \
                    if err_p else errors.berror(int(rc))
                cntl.set_failed(int(rc), text)
                if out.retry_after_ms:
                    cntl.retry_after_ms = int(out.retry_after_ms)
                return None
            payload = _string_at(resp_p, out.resp_len) \
                if out.resp_len else b""
            if nsegs or out.att_len:
                ah = out.att_handle
                if ah:
                    if nsegs == 1:
                        total = out.seg0_nbytes
                        rbuf = NativeAttachment(
                            ah, total, ((out.seg0_key, total,
                                         out.seg0_dev),))
                    else:
                        meta, total = _seg_meta_from_req(out, nsegs)
                        rbuf = NativeAttachment(ah, total, meta)
                else:
                    r_att_host = _string_at(att_p, out.att_len) \
                        if out.att_len else b""
                    rbuf = build_attachment_from_c(r_att_host, out.segs,
                                                   nsegs)
                prev = cntl.__dict__.get("response_attachment")
                if prev is None:
                    cntl.response_attachment = rbuf
                else:
                    prev.append(rbuf)
            # one process-wide byte count for both planes
            with _t._retired_lock:
                moved = _t._retired_moved
                moved[0] += len(req) + len(att_host) + dev_bytes
                moved[1] += dev_bytes
            cntl.error_code_ = 0
            if response_cls is None:
                return payload
            response = response_cls()
            response.ParseFromString(payload)
            cntl.response = response
            return response
        finally:
            cntl.latency_us = (_time.monotonic_ns() - t0) // 1000
            # free and NULL every out pointer: the block is reused (per
            # thread, and re-entered by nested calls of inline handlers)
            free = self._free
            if resp_p:
                free(resp_p)
                out.resp = None
            if att_p:
                free(att_p)
                out.att = None
            if segs_p0:
                free(segs_p0)
                out.segs = None
            if err_p:
                free(err_p)
                out.err_text = None

    def call_fused(self, full_name: str, cntl, request: Any,
                   response_cls, chan):
        """The sync client path in one place: ``Channel.call_method``'s
        context and default preamble, the per-call screens, the call, and
        the shed-retry and re-route tails entered only on their error.
        Returns FUSED_FALLTHROUGH when the call must take the Python plane
        (frame too large, hedging configured, a dead connection's
        re-route)."""
        opts = chan.options
        ctx = getattr(_reqctx_tls, "ctx", None)
        if ctx is not None:
            if cntl.priority is None and ctx.priority is not None:
                cntl.priority = ctx.priority
            if not cntl.tenant and ctx.tenant:
                cntl.tenant = ctx.tenant
            residual = ctx.residual_deadline_ms()
            if residual is not None:
                if residual <= 0:
                    cntl.set_failed(
                        errors.ERPCTIMEDOUT,
                        "inherited deadline budget spent before call")
                    if cntl.span is not None:
                        self._end_span(cntl)
                    return None
                base = cntl.timeout_ms if cntl.timeout_ms is not None \
                    else opts.timeout_ms
                if base is None or base <= 0 or base > residual:
                    cntl.timeout_ms = max(int(residual), 1)
        if cntl.priority is None and opts.priority is not None:
            cntl.priority = opts.priority
        if not cntl.tenant and opts.tenant:
            cntl.tenant = opts.tenant
        # the per-call screens (Channel._fast_call_fits)
        if opts.backup_request_ms > 0:
            return FUSED_FALLTHROUGH
        req_att = cntl.__dict__.get("request_attachment")
        if req_att is None:
            att_len = 0
        elif type(req_att) is IOBuf:
            att_len = req_att._size
        else:
            att_len = len(req_att)     # a lazy view answers uninflated
        try:
            req_sz = request.ByteSize()
        except Exception:
            req_sz = 0
        if att_len + req_sz + 65536 > self.window_bytes:
            return FUSED_FALLTHROUGH
        if cntl.timeout_ms is None:
            cntl.timeout_ms = opts.timeout_ms
        if cntl.span is None and self._rpcz_flag.value:
            self._start_span(cntl, full_name)
        hot = self._hot
        if hot is None:
            hot = self._hot = _hot_modules()
        if hot[0]._active is not None:
            # fault injection armed: call() carries its drop and sever
            result = self.call(full_name, cntl, request, response_cls)
        else:
            result = self._issue(full_name, cntl, request, response_cls)
        ec = cntl.error_code_
        if ec:
            if ec == errors.ELIMIT and cntl.retry_after_ms > 0:
                result = chan._native_shed_retry(
                    self, full_name, cntl, request, response_cls, result)
                ec = cntl.error_code_
            if ec == errors.EFAILEDSOCKET or (
                    ec == errors.EOVERCROWDED
                    and cntl.error_text_.startswith("frame larger")):
                if chan._native_ici_fallback(cntl):
                    return FUSED_FALLTHROUGH
        if cntl.span is not None:
            self._end_span(cntl)
        return result


class _Callers:
    """Threads that run asynchronous native calls.  A call parks in the
    core until its answer; on a scheduler worker it would hold one for the
    whole wait, and as many parked calls as ``bthread_max_concurrency``
    would starve the handlers of this process's own servers (which run on
    those workers).  So an async call gets a thread of its own here: one
    more starts whenever none is idle, an idle one takes the next, and
    one idle for ``idle_s`` exits, so the pool shrinks back after a
    burst.  It is not capped: a cap would park a call behind calls that
    may wait on it (a handler's nested async call)."""

    def __init__(self, idle_s: float = 2.0):
        self.idle_s = idle_s
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._idle = 0          # idle threads less the queued calls
        self._threads = 0
        self._lock = threading.Lock()

    def threads(self) -> int:
        with self._lock:
            return self._threads

    def submit(self, fn) -> None:
        with self._lock:
            # queued under the lock: an idle thread that times out sees
            # it and stays
            self._q.put(fn)
            if self._idle:
                self._idle -= 1
                return
            self._threads += 1
        threading.Thread(target=self._run, name="ici_native_caller",
                         daemon=True).start()

    def _run(self) -> None:
        while True:
            try:
                fn = self._q.get(timeout=self.idle_s)
            except queue.Empty:
                with self._lock:
                    if self._q.empty():
                        self._idle -= 1
                        self._threads -= 1
                        return
                continue
            try:
                fn()
            except Exception as e:       # the call's own path reports it
                log.error("async native call raised: %s", e, exc_info=True)
            fn = None
            with self._lock:
                self._idle += 1


_callers = _Callers()


def run_async(fn) -> None:
    """Run ``fn`` (an asynchronous native call) on a caller thread."""
    _callers.submit(fn)


def native_ici_echo_p50_us(iters: int = 3000, payload: int = 128,
                           device_array=None) -> float:
    """The C++ client loop's echo p50 (µs) over the whole native datapath
    (window, frame codec, queue hop, dispatch, correlation wake).  With
    ``device_array`` each frame carries it as a device ref (resident: the
    pure ref-pass round trip).  -1 when the core is unavailable."""
    lib = native.load()
    if lib is None or not ensure_hooks():
        return -1.0
    key, nbytes, dev = 0, 0, 0
    if device_array is not None:
        nbytes = int(device_array.numel() * device_array.element_size())
        dev = _device_index(device_array)
        key = _registry.put(device_array)    # borrowed for the loop
    try:
        ns = lib.brpc_tpu_ici_echo_p50_ns(iters, payload, key, nbytes, dev)
        return ns / 1000.0 if ns > 0 else -1.0
    finally:
        if key:
            _registry.release(key)
