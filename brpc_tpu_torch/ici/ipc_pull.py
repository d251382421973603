"""The fabric's cross-process device leg: the receiver pulls the row.

On a TPU pod the fabric's kind-4 transfer is a remote DMA that the
receiver's device completes (``brpc_tpu/ici/device_plane.py:351-444``).
The port's counterpart on one card is a pull through CUDA IPC:

  * the sender exports the caching-allocator allocation that holds the
    row (``csrc/cuda_ipc.cu``: the handle names the whole allocation, so
    the row's offset rides beside it) and records an interprocess event on
    its current stream after the producer;
  * both ride beside the kind-4 descriptor (:func:`export_row`), under
    the handshake key :data:`HANDSHAKE_KEY`, so no JAX-format peer sees
    them;
  * the receiver maps the handle once per (peer, allocation) — an
    :class:`Importer` per fabric socket caches the mappings, bounded by
    ``ici_fabric_ipc_cache_max``, and unmaps them when the socket closes
    — makes its copy stream wait on the event, and :mod:`.p2p_copy`
    copies from the mapping into a row it owns: one launch per crossing;
  * the sender holds its row (and so the caching allocator's block) until
    the receiver's PULLED, sent once the copy's own event fired.

On the CPU the plain version of the same leg places the row in a POSIX
shared-memory segment named ``brpc_tpu_torch.<pid>.<random hex>`` (never a
deterministic name, so a segment a killed process left cannot collide with
a later one); the receiver maps it and runs the copy's plain version.  The
sender unlinks it at PULLED, at the socket's close or at exit; the
receiver unlinks it too once mapped, and a socket whose peer process died
sweeps that pid's segments (:func:`sweep_segments`).

The compiled fan-out's scatter exports one tensor once for several
pullers (:func:`export_slices`): each slice's export names the same
allocation (or segment) with the slice's own offset.  A slice of a segment
is not unlinked by its receivers, since others still map it; the sender
unlinks it when the last one has pulled.

Nothing here moves bytes on the card except the p2p_copy launch, and
nothing falls back: an export, an open or an event that fails raises
:class:`IpcPullError` (``EINTERNAL``), and the fabric fails the transfer
and its call with it.
"""
from __future__ import annotations

import atexit
import collections
import ctypes
import hashlib
import mmap
import os
import secrets
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..rpc import errors
from .cuda_kernel import BUILD_DIR, CSRC, NVCC_FLAGS

# CUDA IPC mappings a fabric socket keeps open (an LRU): opening a handle
# is costly, and the caching allocator reuses few segments
CACHE_MAX = 64

# the port's own handshake key: a peer that publishes it speaks the
# descriptor extension below
HANDSHAKE_KEY = "torch_ipc"
HANDSHAKE_VERSION = 1

MODE_CUDA = 1
MODE_SHM = 2
MODE_SHM_SLICE = 3             # a slice of a segment several peers map
HANDLE_BYTES = 64              # sizeof(cudaIpcMemHandle_t/EventHandle_t)
SEGMENT_PREFIX = "brpc_tpu_torch."
SHM_DIR = "/dev/shm"
SOURCE = CSRC / "cuda_ipc.cu"


class IpcPullError(ConnectionError):
    """The cross-process device leg refused a transfer; the socket fails
    with :attr:`error_code`, the call with the same code and text."""

    error_code = errors.EINTERNAL


# ---- the CUDA IPC calls (csrc/cuda_ipc.cu) ------------------------------

class _IpcLibrary:
    """``csrc/cuda_ipc.cu`` built with nvcc at first use (plain C
    interface, linked against libcuda for ``cuMemGetAddressRange``) and
    bound with ctypes.  Built and loaded only inside a call, never at
    import."""

    name = "cuda_ipc"

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()

    @property
    def built(self) -> bool:
        return self._lib is not None

    @staticmethod
    def _link_flags() -> List[str]:
        from torch.utils.cpp_extension import CUDA_HOME
        stubs = os.path.join(CUDA_HOME or "", "lib64", "stubs")
        return (["-L" + stubs] if os.path.isdir(stubs) else []) + ["-lcuda"]

    def library_path(self):
        digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(
            NVCC_FLAGS + self._link_flags()).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"

    def build(self) -> float:
        with self._lock:
            if self._lib is not None:
                return 0.0
            t0 = time.monotonic()
            path = self.library_path()
            if not path.exists():
                from torch.utils.cpp_extension import CUDA_HOME
                if CUDA_HOME is None:
                    raise RuntimeError("cuda_ipc: no CUDA toolkit found "
                                       "(nvcc); set CUDA_HOME")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
                       "-o", str(tmp), str(SOURCE), *self._link_flags()]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"cuda_ipc: nvcc failed "
                                       f"({proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.ipc_export.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_ulonglong),
                                       ctypes.POINTER(ctypes.c_ulonglong)]
            lib.ipc_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_void_p)]
            lib.ipc_close.argtypes = [ctypes.c_void_p]
            for fn in (lib.ipc_export, lib.ipc_open, lib.ipc_close):
                fn.restype = ctypes.c_int
            if lib.ipc_handle_size() != HANDLE_BYTES:
                raise RuntimeError("cuda_ipc: unexpected IPC handle size")
            self._lib = lib
            return time.monotonic() - t0

    def export(self, ptr: int, device: int) -> Tuple[bytes, int]:
        """(handle of the allocation holding ``ptr`` on ``device``,
        ``ptr``'s offset in it)."""
        self.build()
        handle = ctypes.create_string_buffer(HANDLE_BYTES)
        offset = ctypes.c_ulonglong()
        size = ctypes.c_ulonglong()
        rc = self._lib.ipc_export(ptr, device, handle, ctypes.byref(offset),
                                  ctypes.byref(size))
        if rc:
            raise IpcPullError(f"CUDA IPC export failed (error {rc})")
        return handle.raw, offset.value

    def open(self, handle: bytes, device: int) -> int:
        self.build()
        base = ctypes.c_void_p()
        rc = self._lib.ipc_open(handle, device, ctypes.byref(base))
        if rc:
            raise IpcPullError(f"CUDA IPC open failed (error {rc})")
        return base.value

    def close(self, base: int) -> None:
        if self._lib is not None:
            self._lib.ipc_close(base)


ipc_lib = _IpcLibrary()


class _CudaRow:
    """``__cuda_array_interface__`` over ``n`` mapped bytes, so the copy
    kernel's wrapper takes the mapping as a flat uint8 tensor (no copy;
    the tensor keeps this object, not the mapping, alive)."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


# ---- sender: exports ------------------------------------------------------

_events_lock = threading.Lock()
_free_events: Dict[int, List["torch.cuda.Event"]] = {}

_segments_lock = threading.Lock()
_live_segments: Set[str] = set()     # this process's, until unlinked


class Export:
    """A sender's export of one row, held with the transfer's pin until
    the receiver's PULLED (or the transfer failed): :meth:`release`
    returns the interprocess event to the pool or unlinks the segment."""

    __slots__ = ("ext", "event", "device", "segment")

    def __init__(self, ext: bytes, event=None, device: int = -1,
                 segment: str = ""):
        self.ext = ext
        self.event = event
        self.device = device
        self.segment = segment

    def release(self) -> None:
        ev, self.event = self.event, None
        if ev is not None:
            with _events_lock:
                _free_events.setdefault(self.device, []).append(ev)
        seg, self.segment = self.segment, ""
        if seg:
            unlink_segment(seg)


def _event(device: int):
    with _events_lock:
        pool = _free_events.get(device)
        if pool:
            return pool.pop()
    return torch.cuda.Event(enable_timing=False, blocking=False,
                            interprocess=True)


def export_row(arr: torch.Tensor) -> Export:
    """Export a flat uint8 row for the peer's pull.  On the card: the
    allocation's IPC handle, the row's offset and an interprocess event
    recorded on the current stream (after whatever produced the row).  On
    the CPU: a fresh shared-memory segment holding the row's bytes.
    Raises IpcPullError."""
    if arr.is_cuda:
        exp, (exp.ext,) = export_slices(arr, [(0, arr.numel())])
        return exp
    name = create_segment(arr)
    raw = name.encode()
    return Export(struct.pack("<BH", MODE_SHM, len(raw)) + raw,
                  segment=name)


def _cuda_ext(handle: bytes, offset: int, ev_handle: bytes,
              device: int) -> bytes:
    return (struct.pack("<B", MODE_CUDA) + handle
            + struct.pack("<Q", offset) + bytes(ev_handle)
            + struct.pack("<i", device))


def export_slices(flat: torch.Tensor,
                  slices: List[Tuple[int, int]]) -> Tuple[Export, List[bytes]]:
    """Export a flat uint8 tensor ONCE for several pullers: ``(the export,
    one extension per (offset, length) slice)``.  On the card the
    allocation's handle is taken once, one interprocess event is recorded
    on the current stream, and each extension carries its slice's offset
    in the allocation; on the CPU one segment holds the tensor and each
    extension names it with the slice's offset.  The caller holds the
    tensor and the export until every puller has pulled.  Raises
    IpcPullError."""
    if flat.is_cuda:
        device = flat.get_device()
        handle, base = ipc_lib.export(flat.data_ptr(), device)
        try:
            ev = _event(device)
            ev.record(torch.cuda.current_stream(device))
            ev_handle = ev.ipc_handle()
        except Exception as e:
            raise IpcPullError(f"CUDA IPC event failed: {e}") from None
        return (Export(b"", event=ev, device=device),
                [_cuda_ext(handle, base + off, ev_handle, device)
                 for off, _n in slices])
    name = create_segment(flat)
    raw = name.encode()
    head = struct.pack("<BH", MODE_SHM_SLICE, len(raw)) + raw
    return (Export(b"", segment=name),
            [head + struct.pack("<Q", off) for off, _n in slices])


def parse_ext(body: bytes, off: int) -> Tuple[tuple, int]:
    """Parse an export at ``body[off:]``: ``((MODE_CUDA, handle, offset,
    event_handle, device) | (MODE_SHM, name) | (MODE_SHM_SLICE, name,
    offset), new offset)``."""
    (mode,) = struct.unpack_from("<B", body, off)
    off += 1
    if mode == MODE_CUDA:
        handle = body[off:off + HANDLE_BYTES]
        off += HANDLE_BYTES
        (offset,) = struct.unpack_from("<Q", body, off)
        off += 8
        ev = body[off:off + HANDLE_BYTES]
        off += HANDLE_BYTES
        (device,) = struct.unpack_from("<i", body, off)
        return (MODE_CUDA, handle, offset, ev, device), off + 4
    if mode in (MODE_SHM, MODE_SHM_SLICE):
        (n,) = struct.unpack_from("<H", body, off)
        off += 2
        name = body[off:off + n].decode()
        off += n
        if mode == MODE_SHM:
            return (MODE_SHM, name), off
        (offset,) = struct.unpack_from("<Q", body, off)
        return (MODE_SHM_SLICE, name, offset), off + 8
    raise IpcPullError(f"unknown device-leg export mode {mode}")


# ---- shared-memory segments (the plain version's carrier) ---------------

def segment_name() -> str:
    return f"{SEGMENT_PREFIX}{os.getpid()}.{secrets.token_hex(8)}"


def create_segment(arr: torch.Tensor) -> str:
    name = segment_name()
    n = int(arr.numel())
    fd = os.open(os.path.join(SHM_DIR, name),
                 os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    with _segments_lock:
        _live_segments.add(name)
    try:
        os.ftruncate(fd, max(n, 1))
        with mmap.mmap(fd, max(n, 1)) as mm:
            view = torch.frombuffer(mm, dtype=torch.uint8, count=n)
            view.copy_(arr)
            del view
    except Exception as e:
        unlink_segment(name)
        raise IpcPullError(f"shared-memory export failed: {e}") from None
    finally:
        os.close(fd)
    return name


def unlink_segment(name: str) -> None:
    with _segments_lock:
        _live_segments.discard(name)
    try:
        os.unlink(os.path.join(SHM_DIR, name))
    except OSError:
        pass


def live_segments() -> List[str]:
    """This process's segments not yet unlinked."""
    with _segments_lock:
        return sorted(_live_segments)


def segments_on_disk(pid: int) -> List[str]:
    """Process ``pid``'s segments in ``/dev/shm`` (a check looks at its
    own run's processes: other runs of the port may share the host)."""
    prefix = f"{SEGMENT_PREFIX}{pid}."
    try:
        return sorted(n for n in os.listdir(SHM_DIR)
                      if n.startswith(prefix))
    except OSError:
        return []


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:                              # a killed child not yet reaped
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def sweep_segments(pid: int) -> int:
    """Unlink the segments of process ``pid`` when it is gone (a killed
    sender cannot unlink its own); returns how many went."""
    if pid <= 0 or pid == os.getpid() or _pid_alive(pid):
        return 0
    names = segments_on_disk(pid)
    for name in names:
        try:
            os.unlink(os.path.join(SHM_DIR, name))
        except OSError:
            pass
    return len(names)


@atexit.register
def _unlink_all() -> None:
    for name in live_segments():
        unlink_segment(name)


# ---- receiver: mappings ---------------------------------------------------

def open_mapping(ext: tuple) -> int:
    """Open one export's memory in this process: the mapped base pointer
    of a CUDA IPC handle.  (A failure here fails the transfer; tests
    replace this function to force one.)"""
    _, handle, _, _, device = ext
    return ipc_lib.open(handle, device)


class Importer:
    """One fabric socket's view of its peer's exports: the CUDA IPC
    mappings, opened once per allocation and kept in an LRU of
    :data:`CACHE_MAX` entries, and the peer's interprocess
    events, opened once each.  ``opens`` and ``hits`` count the mapping
    cache's misses and hits."""

    def __init__(self):
        self._maps: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._events: Dict[bytes, object] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.opens = 0
        self.hits = 0

    def mapped(self) -> int:
        with self._lock:
            return len(self._maps)

    def source(self, ext: tuple, nbytes: int):
        """``(row tensor, ready event or None, release)`` for one export:
        the row is read by the copy kernel after the event; ``release``
        runs once the copy was launched (CPU: done)."""
        if ext[0] == MODE_SHM:
            return open_segment(ext[1], nbytes)
        if ext[0] == MODE_SHM_SLICE:
            return open_segment(ext[1], nbytes, offset=ext[2], unlink=False)
        _, handle, offset, ev_handle, device = ext
        with self._lock:
            if self._closed:
                raise IpcPullError("socket closed before the pull")
            base = self._maps.get(handle)
            if base is not None:
                self._maps.move_to_end(handle)
                self.hits += 1
        if base is None:
            base = open_mapping(ext)
            evicted = []
            with self._lock:
                self.opens += 1
                self._maps[handle] = base
                while len(self._maps) > CACHE_MAX:
                    evicted.append(self._maps.popitem(last=False)[1])
            self._unmap(evicted, device)
        with self._lock:
            ev = self._events.get(ev_handle)
        if ev is None:
            try:
                ev = torch.cuda.Event.from_ipc_handle(device, ev_handle)
            except Exception as e:
                raise IpcPullError(f"CUDA IPC event open failed: {e}") \
                    from None
            with self._lock:
                self._events[ev_handle] = ev
        row = torch.as_tensor(_CudaRow(base + offset, nbytes),
                              device=torch.device("cuda", device))
        return row, ev, None

    @staticmethod
    def _unmap(bases: List[int], device: int) -> None:
        if not bases:
            return
        # a copy launched from a mapping may still be reading it
        from .device_plane import plane
        plane().sync_copies(torch.device("cuda", device))
        for base in bases:
            ipc_lib.close(base)

    def close(self) -> None:
        """Unmap everything (the socket closed)."""
        with self._lock:
            self._closed = True
            maps, self._maps = self._maps, collections.OrderedDict()
            self._events.clear()
        if maps and torch.cuda.is_available():
            self._unmap(list(maps.values()), torch.cuda.current_device())


def open_segment(name: str, nbytes: int, offset: int = 0,
                 unlink: bool = True):
    """The plain leg's open: map the sender's segment (and unlink its
    name unless other receivers still map it: the mapping outlives it);
    the copy reads ``nbytes`` at ``offset`` of the mapping, and
    ``release`` unmaps it once the copy is done.  (Tests replace this
    function to force a failed open on the CPU.)"""
    path = os.path.join(SHM_DIR, name)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as e:
        raise IpcPullError(f"shared-memory open failed: {e}") from None
    try:
        # a private mapping: the row reads the sender's pages, and nothing
        # written here could reach them
        mm = mmap.mmap(fd, max(offset + nbytes, 1), access=mmap.ACCESS_COPY)
    except (OSError, ValueError) as e:
        raise IpcPullError(f"shared-memory map failed: {e}") from None
    finally:
        os.close(fd)
    if unlink:
        try:
            os.unlink(path)
        except OSError:
            pass
    row = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes,
                           offset=offset) \
        if nbytes else torch.empty(0, dtype=torch.uint8)

    def release():
        try:
            mm.close()
        except BufferError:
            pass        # a row still referenced: the GC unmaps it later

    return row, None, release
