"""Multi-process ici://: the cross-process handshake and device leg.

Port of :mod:`brpc_tpu.ici.fabric` (reference src/brpc/rdma/
rdma_endpoint.h:37-108: a connection formed by an out-of-band TCP handshake
that exchanges GID/QPN, payloads moved with an explicit-ACK window, send
buffers freed only on CQ completion).  What the port keeps:

  * **Out-of-band channel.**  A ``torch.distributed.TCPStore`` hosted by
    process 0 at ``coordinator_address`` stands in for the JAX
    coordination service: each process publishes its contact info (control
    address, the ranks it owns, capabilities) under ``brpc_tpu/fabric/<p>``
    and peers read it with a bounded wait.  Store gets and waits carry
    timeouts, so process 0's death fails its peers' lookups instead of
    hanging them.
  * **Control plane.**  One TCP connection per socket pair carries frames
    1-24 in the JAX layouts (HELLO/HELLO_OK/HELLO_ERR, DATA, CREDIT,
    PULLED, FIN, the bulk conn's DOWN/REESTABLISH/OK/ERR, PING, GOODBYE,
    DPLANE_SEQ, the shm ring's DOWN/REESTABLISH/OK/ERR, and the compiled
    fan-out's COLL_CALL/COLL_OK/COLL_ERR/COLL_GO) and the port's own
    frames 40-43 (sent only to peers that published :data:`.ipc_pull.
    HANDSHAKE_KEY`): PULL_ERR, and the fan-out's COLL_RESULT, COLL_FAIL
    and COLL_RELEASE, which carry the bytes the JAX program moves inside
    XLA (see below).
  * **Data plane: kind 4.**  A DEVICE payload at or above
    ``ici_device_plane_threshold`` crosses as a sequenced device-plane
    transfer (:class:`CollectiveSequencer`: one total order of both
    directions, assigned by the server side): the receiver pulls the
    sender's row through CUDA IPC with the p2p_copy kernel at its slot,
    then sends PULLED, and only then does the sender's transfer complete
    and its pin release (:mod:`.ipc_pull`).  The device plane has no
    fallback: a refused export, open or launch fails the transfer, the
    socket and its calls with EINTERNAL and the reason, and latches the
    peer's device plane down for ``DEVICE_RETRY_S``; while it is down
    DEVICE payloads to that peer fail the same way.  They never fall to
    the shm ring, the bulk conn or inline.
  * **Data plane: the same-host tiers** (``csrc/fabric_native.cpp``,
    loaded by :func:`..butil.native.load_fabric`).  Every other payload
    goes through the route table (:mod:`.route`), as in the JAX package:
    the shm ring first (kind 6 host bytes, kind 5 a DEVICE payload the
    device plane does not carry, staged with one device-to-host copy),
    then the bulk conn (kinds 3 and 2: an abstract unix socket between
    processes of one host, TCP otherwise), then inline (kind 0).  Host
    blobs below ``ici_fabric_bulk_host_min`` ride inline.  A failed send
    degrades its plane and falls through within the same frame; a frame
    too large for the ring skips it without degrading it.  Only a
    ``<BQQ>`` descriptor (kinds 3/6) or the array descriptor (kinds 2/5)
    rides the control channel; the receiver claims the bytes by uuid.
    With ``ici_fabric_host_delivery`` (default) a kind-2/5 payload is
    delivered host-resident, a CPU tensor over the native buffer with no
    copy, released exactly once when its last view dies; with the flag
    off it is copied once into an owned tensor on the socket's local
    rank before the read event.  The handshake advertises ``bulk``,
    ``bulk_uds``, ``shm`` and ``host``; the HELLO carries ``bulk_key``
    (the conn the client parked on the server's bulk listener) and
    ``shm_seg`` (the segment it created, which the server attaches and
    unlinks).  The port names its segments
    ``/dev/shm/brpc_tpu_torch_shm.<process>.<random nonce>``, so a segment
    a killed process left behind never blocks a later create.
  * **Plane health.**  Each plane's death with a live control channel
    degrades only that plane: the peer is told (frames 8 and 17), and the
    client side revives it in the background through
    :mod:`.plane_health`'s threaded prober (frames 9-11 and 18-20, one
    ``_PLANE_FRAMES`` table, the attach done on the read loop so it is
    ordered before any descriptor that uses it).
  * **Streams** (:mod:`..rpc.stream`) post DATA frames of at least
    ``ici_stream_bulk_threshold`` through ``stream_fast_begin``/
    ``stream_fast_send`` and claim them with ``stream_bulk_claim``/
    ``stream_shm_claim`` (stream frames 5-7).
  * **Flow control** is the in-process IciSocket's credit window.

  * **Clock alignment.**  The HELLO carries the client's wall clock and
    the HELLO_OK echoes it beside the server's: the client records the
    peer's offset, bounded by half the round trip (:mod:`.clock`), which
    the pod-scope ``/rpcz`` stitcher aligns remote spans with.

  * **The compiled fan-out's cross-process leg**
    (:mod:`..channels.collective_fanout`).  The client announces a fan-out
    on frame 21 to every member process, a member accepts (22) or refuses
    (23), and only once all accepted does the client commit (24).  The
    JSON bodies keep the JAX keys; the announce adds the port's
    ``xrows``/``xrow_bytes``: one export of the operand (base64 of the
    :mod:`.ipc_pull` extension) per fan-out index, each with its row's
    offset, which the member pulls with one ``p2p_copy`` launch per row
    it owns.  Then, the port's own:

      - COLL_RESULT (41), member to client, json ``{uuid, pid, rows:
        [{idx, ext, nbytes, shape, dtype}]}``: the member ran its bodies;
        each result's export, which the client pulls with one launch (no
        rows under MERGE_NONE).  It also says the member's scatter pulls
        are done;
      - COLL_FAIL (42), member to client, json ``{uuid, pid, reason}``:
        the member's entry failed after the commit;
      - COLL_RELEASE (43), client to member, json ``{uuid, cpid}``: the
        client has pulled the results; the member's pins release.

  * **Fault plan.**  The control-channel, handshake and device knobs of
    :class:`..rpc.fault_injection.FabricFaultPlan` act here: every
    outbound control frame passes ``on_control_send``, every inbound one
    ``on_control_recv``, a HELLO ``on_hello``, a pull at its slot
    ``on_plane_op(sock, "device")`` and a ring send ``on_plane_op(sock,
    "shm")``; a freshly attached bulk conn or ring gets the plan's native
    knobs (``on_bulk_attach``/``on_shm_attach``) and each plane
    (re)establishment asks ``on_bulk_handshake``/``on_shm_handshake``.

Pod membership (:mod:`.pod`) lives on the same store.  Left out: the
transfer server (kind 1; the handshake advertises no ``xfer`` key, so a
peer never routes there) and the JAX package's bulk-carried kind-4 leg
(``_dplane_execute_bulk``), which moves kind 4 over the bulk conn on
backends without multi-controller collectives: the port's kind 4 is the
IPC pull.

Addressing: :class:`~.mesh.IciMesh` is the same in every process, and
process p of P owns a contiguous block of its ranks
(:meth:`~.mesh.IciMesh.process_block`, or the ``ranks`` given to
:meth:`FabricNode.initialize`), published as the handshake info's
``devices``.  :func:`connect_any` routes a rank this process owns through
the in-process IciSocket and any other through a FabricSocket, so Server
and Channel code is the same single- or multi-process.
"""
from __future__ import annotations

import collections
import ctypes
import itertools
import json
import os
import socket as _pysocket
import struct
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

from ..butil import flags as _flags
from ..butil import logging as log
from ..butil import native as _native
from ..butil.iobuf import IOBuf, IOPortal, DEVICE
from ..rpc import errors
from ..rpc import fault_injection as _fi
from ..rpc.socket import Socket
from . import device_plane as _dp
from . import ipc_pull as _ipc
from . import plane_health as _ph
from . import route as _route
from .transport import CreditWindow, OrderedDelivery

_KV_PREFIX = "brpc_tpu/fabric/"

# seconds a down-latched device plane waits before it re-probes (the JAX
# package's ici_device_plane_retry_s default)
DEVICE_RETRY_S = 2.0
# seconds a store get or wait may block: process 0's death fails its
# peers' lookups within this
STORE_TIMEOUT_S = 30.0

# the same-host tiers' flags, with the JAX package's defaults
_flags.define_flag("ici_fabric_bulk", True,
                   "same-host and cross-host fabric payloads the device "
                   "plane does not carry may ride the native bulk conn")
_flags.define_flag("ici_fabric_bulk_host_min", 64 * 1024,
                   "min host-chunk bytes routed over the bulk plane",
                   _flags.positive_integer)
_flags.define_flag("ici_fabric_host_delivery", True,
                   "deliver kind-2/5 payloads host-resident (False: an "
                   "owned copy on the socket's local rank before the "
                   "read event)")
_flags.define_flag("ici_bulk_claim_timeout_s", 60.0,
                   "max seconds a bulk or shm claim waits for its frame")
_flags.define_flag("ici_fabric_shm", True,
                   "same-host fabric pairs add the mmap ring bulk tier "
                   "(False: UDS/TCP bulk only)")
_flags.define_flag("ici_shm_ring_bytes", 32 * 1024 * 1024,
                   "per-direction shm ring capacity per socket pair",
                   _flags.positive_integer)
_flags.define_flag("ici_shm_send_timeout_s", 20.0,
                   "max seconds an shm ring send waits for space before "
                   "the plane is declared dead")
_flags.define_flag("ici_shm_stripes", 0,
                   "SPSC ring-pair stripes per shm segment (0 = auto: "
                   "1 on 1-core hosts, else min(4, host cores))")

_SHM_STRIPE_SHIFT = 56          # the stripe rides the uuid's top byte
# the port's segment names; the JAX package's are brpc_tpu_shm.<p>.<uuid>
SHM_PREFIX = "brpc_tpu_torch_shm."


def _resolve_shm_stripes() -> int:
    n = int(_flags.get_flag("ici_shm_stripes"))
    if n <= 0:
        cores = os.cpu_count() or 1
        return 1 if cores <= 1 else min(4, cores)
    return min(n, 64)


def shm_segments_on_disk(process_id: Optional[int] = None) -> List[str]:
    """The port's ring segments still named in /dev/shm (of fabric
    process ``process_id``, default every one).  A segment is unlinked
    once its peer attached, so a live pair leaves none."""
    want = SHM_PREFIX + ("" if process_id is None else f"{process_id}.")
    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(want))
    except OSError:
        return []


_u8p = ctypes.POINTER(ctypes.c_uint8)


class _NativeBufOwner:
    """Releases one claimed native buffer exactly once, when the last
    view over it dies: chained from a tensor through ``torch.frombuffer``
    to the ctypes array whose ``_owner`` this is.  ``release_fn`` is the
    plane's entry point: the bulk conn's ``fab_buf_release`` (back to the
    conn's pool) or the ring's ``shm_release`` (the slot retires)."""

    __slots__ = ("_release", "_conn", "_ptr", "_len")

    def __init__(self, release_fn, conn, ptr, length):
        self._release, self._conn, self._ptr = release_fn, conn, ptr
        self._len = length

    def __del__(self):
        try:
            self._release(self._conn, self._ptr, self._len)
        except Exception:
            pass


class _ShmOversize(Exception):
    """The frame can never fit this ring: route it elsewhere without
    degrading the (healthy) ring."""


def _fab_lib():
    """The bulk-and-shm library when the bulk plane is enabled."""
    if not _flags.get_flag("ici_fabric_bulk"):
        return None
    return _native.load_fabric()


def _host_ptr(data):
    """(pointer, length, keep) of bytes or a contiguous CPU tensor; keep
    pins the memory for the native call."""
    if isinstance(data, (bytes, bytearray)):
        if isinstance(data, bytearray):
            data = bytes(data)
        return ctypes.cast(data, _u8p), len(data), data
    return (ctypes.cast(data.data_ptr(), _u8p), data.numel(), data)

# control-channel frame types (the JAX layouts, brpc_tpu/ici/fabric.py:
# 219-248)
_F_HELLO = 1       # json: {target_dev, client_dev, pid, wall_us}
_F_HELLO_OK = 2
_F_HELLO_ERR = 3
_F_DATA = 4        # chunk list: host bytes + device descriptors
_F_CREDIT = 5      # u64 consumed bytes
_F_PULLED = 6      # u64 uuid: the receiver's copy finished
_F_FIN = 7         # [u32 close code]
# the bulk conn's degrade and revival, in this order: DOWN (the sender
# saw it die; the peer degrades too), REESTABLISH (json {bulk_key}: the
# client parked a fresh conn), OK (the server claimed and attached it),
# ERR (refused; the client backs off and retries)
_F_BULK_DOWN, _F_BULK_REESTABLISH, _F_BULK_OK, _F_BULK_ERR = 8, 9, 10, 11
_F_PING = 12       # u32 target_dev
_F_PING_OK = 13
_F_PING_ERR = 14
_F_GOODBYE = 15
_F_DPLANE_SEQ = 16  # u64 uuid, i64 seq
# the shm ring's twin of 8-11 (REESTABLISH carries json {shm_seg}: a
# fresh segment for the server to attach and unlink)
_F_SHM_DOWN, _F_SHM_REESTABLISH, _F_SHM_OK, _F_SHM_ERR = 17, 18, 19, 20
# one read-loop table for both planes: {ftype: (plane, op)}, op 0..3 =
# down/reestablish/ok/err (FabricSocket._on_plane_frame)
_PLANE_FRAMES = {b + i: (w, i)
                 for w, b in (("bulk", _F_BULK_DOWN), ("shm", _F_SHM_DOWN))
                 for i in range(4)}
# the compiled fan-out's announce (brpc_tpu/ici/fabric.py:275-279)
_F_COLL_CALL = 21   # json: {method, seq, devices, mapping, merge, shape,
                    #        dtype, uuid, cpid} + the port's xrows/xrow_bytes
_F_COLL_OK = 22     # json: {uuid, pid}: accepted, the entry parked
_F_COLL_ERR = 23    # json: {uuid, pid, reason}: refused
_F_COLL_GO = 24     # json: {uuid, cpid}: commit, the parked entry runs
# the port's own: the receiver's pull failed (u64 uuid, u32 code, text);
# only a peer that published the ipc_pull handshake key is sent one
_F_PULL_ERR = 40
# the port's own fan-out frames (module docstring), json bodies
_F_COLL_RESULT = 41
_F_COLL_FAIL = 42
_F_COLL_RELEASE = 43

_COLL_FRAMES = (_F_COLL_CALL, _F_COLL_OK, _F_COLL_ERR, _F_COLL_GO,
                _F_COLL_RESULT, _F_COLL_FAIL, _F_COLL_RELEASE)

_HDR = struct.Struct("<BI")          # type, body length


def _send_frame(sock: _pysocket.socket, ftype: int, body: bytes) -> None:
    sock.sendall(_HDR.pack(ftype, len(body)) + body)


def _recv_exact(sock: _pysocket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: _pysocket.socket) -> Optional[Tuple[int, bytes]]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    ftype, length = _HDR.unpack(hdr)
    body = _recv_exact(sock, length) if length else b""
    if length and body is None:
        return None
    return ftype, body


def encode_device_descriptor(uuid: int, nbytes: int, src_dev: int, seq: int,
                             trace_id: int = 0, parent_span_id: int = 0,
                             ext: bytes = b"") -> bytes:
    """One kind-4 chunk of a DATA frame, byte for byte the JAX package's
    (``<BQH`` kind/uuid/dtype length, the dtype, ``<B`` ndim, the shape,
    ``<Q`` length, ``<IqQQ`` src/seq/trace), then the port's export when
    the peer speaks it."""
    dt = b"uint8"
    return (struct.pack("<BQH", 4, uuid, len(dt)) + dt
            + struct.pack("<B", 1) + struct.pack("<1Q", nbytes)
            + struct.pack("<Q", nbytes)
            + struct.pack("<IqQQ", src_dev, seq, trace_id, parent_span_id)
            + ext)


def encode_array_descriptor(kind: int, uuid: int, nbytes: int) -> bytes:
    """One kind-2 or kind-5 chunk: a flat uint8 payload claimed by uuid,
    byte for byte the JAX package's (``<BQH`` kind/uuid/dtype length, the
    dtype, ``<B`` ndim, the shape, ``<Q`` length)."""
    dt = b"uint8"
    return (struct.pack("<BQH", kind, uuid, len(dt)) + dt
            + struct.pack("<B", 1) + struct.pack("<1Q", nbytes)
            + struct.pack("<Q", nbytes))


class FabricNode:
    """Per-process fabric runtime: the control listener and the store."""

    _instance: Optional["FabricNode"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.process_id = -1
        self.num_processes = 0
        self.mesh = None
        self.devices: List[int] = []
        self._store = None
        self._store_lock = threading.Lock()
        self._store_closed = False           # set by quiesce, under the lock
        self._ctrl_listener: Optional[_pysocket.socket] = None
        self.ctrl_addr = ""
        self.host_ip = ""
        self._uuid_lock = threading.Lock()
        self._next_uuid = 1
        self._peers: Dict[int, dict] = {}            # pid -> contact info
        self._peers_lock = threading.Lock()
        self._device_health: Dict[int, _ph.PlaneHealth] = {}
        self._accept_thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._bulk_lib = None                         # fabric_native handle
        self._bulk_listener = 0                       # its listener handle
        self.bulk_addr = ""
        self.bulk_uds = ""
        # the shm ring: probed at start (a denied /dev/shm leaves the
        # capability unadvertised)
        self._shm_ok = False
        self._shm_lib = None

    # ---- lifecycle -----------------------------------------------------
    @classmethod
    def instance(cls) -> Optional["FabricNode"]:
        with cls._lock:
            return cls._instance

    @classmethod
    def initialize(cls, coordinator_address: str, num_processes: int,
                   process_id: int, host_ip: Optional[str] = None,
                   ranks=None, mesh=None) -> "FabricNode":
        """Join the fabric: process 0 hosts the store at
        ``coordinator_address`` (``host:port``), every process publishes
        its contact info there.  ``ranks``: the ranks of ``mesh`` (default:
        the default mesh, which asks for the card) this process owns;
        default its contiguous block.  ``host_ip`` is the address
        published to peers; None derives it from the route to the
        coordinator.  Idempotent per process."""
        with cls._lock:
            if cls._instance is not None:
                return cls._instance
            node = FabricNode()
            node._start(coordinator_address, num_processes, process_id,
                        host_ip, ranks, mesh)
            cls._instance = node
            import atexit
            atexit.register(cls._atexit_quiesce)
            return node

    @classmethod
    def _atexit_quiesce(cls) -> None:
        with cls._lock:
            node = cls._instance
        if node is not None:
            try:
                node.quiesce()
            except Exception:
                pass

    def _start(self, coordinator_address, num_processes, process_id,
               host_ip, ranks, mesh) -> None:
        from torch.distributed import TCPStore
        from .mesh import IciMesh
        self.mesh = mesh or IciMesh.default()
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.devices = sorted(int(r) for r in (
            ranks if ranks is not None else self.mesh.process_block(
                self.process_id, self.num_processes)))
        host, _, port = coordinator_address.rpartition(":")
        self._store = TCPStore(host.strip("[]"), int(port),
                               is_master=self.process_id == 0,
                               timeout=timedelta(seconds=STORE_TIMEOUT_S),
                               wait_for_workers=False)
        if host_ip is None:
            host_ip = self._derive_host_ip(coordinator_address)
        self.host_ip = host_ip
        self._ctrl_listener = _pysocket.socket()
        self._ctrl_listener.setsockopt(_pysocket.SOL_SOCKET,
                                       _pysocket.SO_REUSEADDR, 1)
        self._ctrl_listener.bind((host_ip, 0))
        self._ctrl_listener.listen(64)
        self.ctrl_addr = "%s:%d" % self._ctrl_listener.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fabric_accept", daemon=True)
        self._accept_thread.start()
        self._start_tiers()
        # the handshake publication (the GID/QPN exchange)
        info = {"ctrl": self.ctrl_addr, "devices": self.devices,
                "host": self.host_ip, "os_pid": os.getpid()}
        if self.bulk_addr:
            info["bulk"] = self.bulk_addr
            if self.bulk_uds:
                # same-host peers dial the abstract unix socket; "host"
                # tells same-host from the same address on another host
                info["bulk_uds"] = self.bulk_uds
        if self._shm_ok:
            # same-host peers may hand a segment name at HELLO
            info["shm"] = 1
        if _flags.get_flag("ici_device_plane"):
            # the sequenced, traced kind-4 descriptor (<IqQQ>), the JAX
            # package's version-3 advert
            info["dplane3"] = 3
            info[_ipc.HANDSHAKE_KEY] = _ipc.HANDSHAKE_VERSION
        with self._store_lock:
            self._store.set(_KV_PREFIX + str(self.process_id),
                            json.dumps(info))
        log.info("fabric: process %d/%d up ctrl=%s ranks=%s",
                 self.process_id, self.num_processes, self.ctrl_addr,
                 self.devices)

    def _start_tiers(self) -> None:
        """The bulk listener (TCP and an abstract unix socket) and the shm
        capability probe: can this process create, map and unlink a
        segment?  Either missing leaves its advert out, and peers keep
        the next tier."""
        lib = _fab_lib()
        if lib is None:
            return
        port_out = ctypes.c_int()
        uds_out = ctypes.create_string_buffer(108)
        lh = lib.brpc_tpu_torch_fab_listen(self.host_ip.encode(),
                                           ctypes.byref(port_out),
                                           uds_out, 108)
        if lh:
            self._bulk_lib = lib
            self._bulk_listener = lh
            self.bulk_addr = f"{self.host_ip}:{port_out.value}"
            self.bulk_uds = uds_out.value.decode()
        if _flags.get_flag("ici_fabric_shm"):
            probe = f"brpc_tpu_torch_shm_probe.{os.getpid()}." \
                    f"{os.urandom(6).hex()}".encode()
            ph = lib.brpc_tpu_torch_shm_create(probe, 64 * 1024)
            if ph:
                lib.brpc_tpu_torch_shm_unlink(probe)
                lib.brpc_tpu_torch_shm_close(ph)
                self._shm_ok = True
                self._shm_lib = lib

    @staticmethod
    def _derive_host_ip(coordinator_address: Optional[str]) -> str:
        """The IP this host uses to reach the coordinator: the address
        peers reach this process on.  A UDP connect sends no packet."""
        if coordinator_address:
            host, sep, port = coordinator_address.rpartition(":")
            if not sep:
                host, port = coordinator_address, ""
            host = host.strip("[]")
            s = _pysocket.socket(_pysocket.AF_INET, _pysocket.SOCK_DGRAM)
            try:
                s.connect((host, int(port) if port.isdigit() else 1))
                return s.getsockname()[0]
            except (OSError, ValueError):
                pass
            finally:
                s.close()
        return "127.0.0.1"

    def shutdown(self) -> None:
        self._shutdown = True
        lst, self._ctrl_listener = self._ctrl_listener, None
        if lst is not None:
            try:
                lst.shutdown(_pysocket.SHUT_RDWR)
            except OSError:
                pass
            try:
                lst.close()
            except OSError:
                pass
        lh, self._bulk_listener = self._bulk_listener, 0
        if lh and self._bulk_lib is not None:
            self._bulk_lib.brpc_tpu_torch_fab_listener_close(lh)

    def quiesce(self) -> None:
        """Close the listeners, sever every live fabric socket's control
        conn and join its reader, then the accept loop, then close and
        join every native bulk conn: after this no fabric thread runs, so
        exit-time teardown has nothing to race."""
        self.shutdown()
        # no thread is inside a store call once the lock is ours, and none
        # enters one after: a daemon thread (a health probe, a pod
        # refresh) cut off inside a torch call at the interpreter's exit
        # would abort the process
        with self._store_lock:
            self._store_closed = True
        from ..rpc.socket import list_sockets
        for s in list(list_sockets()):
            if isinstance(s, FabricSocket):
                s.quiesce_reader()
        t = self._accept_thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(2.0)
        if self._bulk_lib is not None:
            self._bulk_lib.brpc_tpu_torch_fab_quiesce()

    # ---- registry ------------------------------------------------------
    def peer_info(self, pid: int, timeout_ms: int = 30000,
                  fresh: bool = False) -> dict:
        """Process ``pid``'s published contact info, waiting at most
        ``timeout_ms`` for it; ``fresh`` re-reads a cached entry (a peer
        that restarted publishes a new address)."""
        with self._peers_lock:
            info = None if fresh else self._peers.get(pid)
        if info is not None:
            return info
        key = _KV_PREFIX + str(pid)
        deadline = time.monotonic() + timeout_ms / 1000.0
        try:
            # poll rather than block in the store's wait: the store lock
            # is shared with the pod's reads and writes, which must not
            # stall behind a peer that has not published yet
            while True:
                with self._store_lock:
                    if self._store_closed:
                        raise ConnectionError("the node is shut down")
                    if self._store.check([key]):
                        raw = self._store.get(key)
                        break
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"not published within "
                                       f"{timeout_ms} ms")
                time.sleep(0.01)
        except Exception as e:
            raise ConnectionRefusedError(
                f"fabric: no contact info for process {pid}: {e}") from None
        info = json.loads(raw)
        with self._peers_lock:
            self._peers[pid] = info
        return info

    def forget_peer(self, pid: int) -> None:
        """Drop a cached contact: the next lookup re-reads the store."""
        with self._peers_lock:
            self._peers.pop(pid, None)

    def owns(self, rank: int) -> bool:
        return rank in self.devices

    def device_owner(self, rank: int, timeout_ms: int = 30000) -> int:
        """The process owning ``rank`` (its published ``devices``)."""
        if self.owns(rank):
            return self.process_id
        for pid in range(self.num_processes):
            if pid == self.process_id:
                continue
            if rank in self.peer_info(pid, timeout_ms)["devices"]:
                return pid
        raise ConnectionRefusedError(f"fabric: no process owns ici://{rank}")

    def next_uuid(self) -> int:
        with self._uuid_lock:
            u = (self.process_id + 1) << 40 | self._next_uuid
            self._next_uuid += 1
            return u

    def device_health(self, pid: int) -> _ph.PlaneHealth:
        """The device plane's health toward process ``pid``, shared by
        every socket to it: a latch set on one holds for the next."""
        with self._peers_lock:
            rec = self._device_health.get(pid)
            if rec is None:
                rec = self._device_health[pid] = _ph.register_plane(
                    "device", threading.Lock(),
                    retry_s=lambda: DEVICE_RETRY_S)
            return rec

    # ---- server side ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._shutdown:
            lst = self._ctrl_listener
            if lst is None:
                return
            try:
                conn, _ = lst.accept()
            except OSError:
                return
            threading.Thread(target=self._handshake_server, args=(conn,),
                             name="fabric_handshake", daemon=True).start()

    def _handshake_server(self, conn: _pysocket.socket) -> None:
        from .transport import _listeners, _listeners_lock
        # every exit that does not hand the client's parked bulk conn to a
        # socket releases it: a refused handshake would otherwise leak an
        # fd and a reader thread under a key nobody claims
        bulk_h = 0
        bulk_key = None
        shm_h = 0
        try:
            conn.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
            conn.settimeout(30)
            fr = _recv_frame(conn)
            if fr is not None and fr[0] == _F_PING:
                # a liveness probe: answer and close, no socket is made
                (target,) = struct.unpack("<I", fr[1])
                with _listeners_lock:
                    listener = _listeners.get(target)
                up = listener is not None and not listener.draining
                _send_frame(conn, _F_PING_OK if up else _F_PING_ERR, b"")
                conn.close()
                return
            if fr is None or fr[0] != _F_HELLO:
                conn.close()
                return
            hello = json.loads(fr[1])
            bulk_key = hello.get("bulk_key")
            target = hello["target_dev"]
            plan = _fi.fabric_active()
            if plan is not None and plan.on_hello():
                _send_frame(conn, _F_HELLO_ERR, b"injected hello refusal")
                conn.close()
                self._reap_parked_bulk(bulk_key)
                return
            with _listeners_lock:
                listener = _listeners.get(target)
            if listener is None:
                _send_frame(conn, _F_HELLO_ERR,
                            f"no server at ici://{target}".encode())
                conn.close()
                self._reap_parked_bulk(bulk_key)
                return
            # the bulk conn: the client dialed it before the HELLO, so the
            # claim usually returns at once.  A key that was never dialed
            # is refused: the client would send descriptors nobody claims
            if bulk_key:
                if self._bulk_listener and self._bulk_lib is not None:
                    bulk_h = self._bulk_lib.brpc_tpu_torch_fab_accept(
                        self._bulk_listener, bulk_key.encode(), 15_000_000)
                if not bulk_h:
                    _send_frame(conn, _F_HELLO_ERR,
                                b"bulk plane binding failed")
                    conn.close()
                    return
            # the shm ring: attach the client's segment and unlink it (the
            # mapping outlives the name).  A failed attach is soft: the
            # client binds its end only on our ack
            shm_name = hello.get("shm_seg")
            if shm_name and self._shm_ok and self._shm_lib is not None \
                    and _flags.get_flag("ici_fabric_shm"):
                refused = plan is not None and plan.on_shm_handshake()
                if not refused:
                    shm_h = self._shm_lib.brpc_tpu_torch_shm_attach(
                        shm_name.encode())
                    if shm_h:
                        self._shm_lib.brpc_tpu_torch_shm_unlink(
                            shm_name.encode())
            conn.settimeout(None)
            sock = FabricSocket(conn, local_dev=target,
                                remote_dev=hello["client_dev"],
                                peer_pid=hello["pid"], node=self,
                                fresh_info=True)
            sock.is_server_side = True
            sock._attach_bulk(self._bulk_lib, bulk_h)
            bulk_h = 0                       # the socket holds it now
            if shm_h:
                sock._attach_shm(self._shm_lib, shm_h)
                shm_h = 0
            # the messenger attaches before any frame can be read
            listener.on_accept(sock)
            ok = {}
            if "wall_us" in hello:
                ok = {"t0": hello["wall_us"],
                      "wall_us": time.time_ns() // 1000}
            if sock.shm_bound():
                ok["shm"] = True
            _send_frame(conn, _F_HELLO_OK,
                        json.dumps(ok).encode() if ok else b"")
            sock.start_io()
        except Exception as e:
            log.error("fabric handshake failed: %s", e)
            try:
                conn.close()
            except OSError:
                pass
            if bulk_h and self._bulk_lib is not None:
                self._bulk_lib.brpc_tpu_torch_fab_conn_close(bulk_h)
            else:
                self._reap_parked_bulk(bulk_key)
            if shm_h and self._shm_lib is not None:
                self._shm_lib.brpc_tpu_torch_shm_close(shm_h)

    # a refused handshake's parked bulk conn is claimed and closed with a
    # short wait: the acceptor may not have read its key header yet
    _REAP_CLAIM_US = 2_000_000

    def _reap_parked_bulk(self, bulk_key: Optional[str]) -> None:
        if not bulk_key or not self._bulk_listener \
                or self._bulk_lib is None:
            return
        h = self._bulk_lib.brpc_tpu_torch_fab_accept(
            self._bulk_listener, bulk_key.encode(), self._REAP_CLAIM_US)
        if h:
            self._bulk_lib.brpc_tpu_torch_fab_conn_close(h)

    # ---- the same-host tiers, dialing side -----------------------------
    def dial_bulk(self, peer_pid: int, info: Optional[dict] = None
                  ) -> Tuple[int, Optional[str], object, bool]:
        """Dial the peer's bulk listener and park a fresh conn under a
        unique key: (handle, key, lib, is_uds), or (0, None, lib, False)
        when either end lacks the bulk plane.  The initial connect and the
        revival share it; a revival passes the contact its socket was made
        with (the store is not read from a prober thread)."""
        lib = _fab_lib()
        bulk_h, bulk_key, is_uds = 0, None, False
        if info is None:
            info = self.peer_info(peer_pid)
        if lib is not None and info.get("bulk"):
            bhost, _, bport = info["bulk"].rpartition(":")
            bulk_key = f"{self.process_id}:{self.next_uuid():x}"
            if info.get("bulk_uds") and info.get("host") == self.host_ip:
                bulk_h = lib.brpc_tpu_torch_fab_connect_uds(
                    info["bulk_uds"].encode(), bulk_key.encode())
                is_uds = bool(bulk_h)
            if not bulk_h:
                bulk_h = lib.brpc_tpu_torch_fab_connect(
                    bhost.encode(), int(bport), bulk_key.encode())
            if not bulk_h:
                bulk_key = None
        return bulk_h, bulk_key, lib, is_uds

    def shm_peer_ok(self, peer_pid: int) -> bool:
        """Both ends hold the shm capability and share this host.  The
        flag is read again at connect time, so turning the tier off after
        the node joined holds for every later socket."""
        if not self._shm_ok or not _flags.get_flag("ici_fabric_shm"):
            return False
        try:
            info = self.peer_info(peer_pid)
        except Exception:
            return False
        return bool(info.get("shm")) and info.get("host") == self.host_ip

    def create_shm_segment(self) -> Tuple[int, Optional[str], object]:
        """A fresh ring segment, created by the dialing side: (handle,
        name, lib), or (0, None, None).  The name carries a random nonce,
        never repeated across runs, so a segment a killed process left
        behind cannot make this exclusive create fail."""
        if not self._shm_ok or self._shm_lib is None:
            return 0, None, None
        lib = self._shm_lib
        name = f"{SHM_PREFIX}{self.process_id}.{os.urandom(8).hex()}"
        ring = int(_flags.get_flag("ici_shm_ring_bytes"))
        stripes = _resolve_shm_stripes()
        if stripes > 1:
            h = lib.brpc_tpu_torch_shm_create2(name.encode(), ring, stripes)
        else:
            h = lib.brpc_tpu_torch_shm_create(name.encode(), ring)
        if not h:
            return 0, None, None
        return h, name, lib

    def drop_shm_segment(self, h: int, name: Optional[str]) -> None:
        """Abandon a created segment nobody attached: close it and remove
        its name."""
        if self._shm_lib is None:
            return
        if h:
            self._shm_lib.brpc_tpu_torch_shm_close(h)
        if name:
            self._shm_lib.brpc_tpu_torch_shm_unlink(name.encode())

    # ---- client side ---------------------------------------------------
    def _ctrl_address(self, target_dev: int, timeout_ms: int,
                      fresh: bool) -> Tuple[int, str, int]:
        owner = self.device_owner(target_dev, timeout_ms)
        info = self.peer_info(owner, timeout_ms, fresh=fresh)
        host, _, port = info["ctrl"].rpartition(":")
        return owner, host, int(port)

    def ping(self, target_dev: int, timeout: float = 1.0) -> bool:
        """Is ici://target_dev served by its owner process?  The health
        checker's probe for a rank another process owns; it re-reads the
        owner's contact (a restarted peer listens elsewhere) and makes no
        fabric socket."""
        try:
            _, host, port = self._ctrl_address(
                target_dev, int(timeout * 1000), fresh=True)
            with _pysocket.create_connection((host, port),
                                             timeout=timeout) as conn:
                conn.settimeout(timeout)
                _send_frame(conn, _F_PING, struct.pack("<I", target_dev))
                fr = _recv_frame(conn)
                return fr is not None and fr[0] == _F_PING_OK
        except (OSError, ValueError, KeyError):
            return False

    def connect(self, target_dev: int, client_dev: int) -> "FabricSocket":
        for fresh in (False, True):
            owner, host, port = self._ctrl_address(target_dev, 30000, fresh)
            try:
                conn = _pysocket.create_connection((host, port), timeout=30)
                break
            except OSError:
                # a stale contact (the peer restarted and listens
                # elsewhere): read the store again, once
                self.forget_peer(owner)
                if fresh:
                    raise
        conn.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
        # the bulk conn is dialed first, so its key is parked when the
        # HELLO names it; the segment is created before the HELLO that
        # names it, and bound only on the server's ack
        bulk_h, bulk_key, lib, bulk_uds = self.dial_bulk(owner)
        shm_h, shm_name, shm_lib = (0, None, None)
        if self.shm_peer_ok(owner):
            shm_h, shm_name, shm_lib = self.create_shm_segment()
        hello = {"target_dev": target_dev, "client_dev": client_dev,
                 "pid": self.process_id,
                 # clock alignment: our wall at HELLO send; the HELLO_OK
                 # echo and the server's wall bound the peer's offset by
                 # this round trip (±RTT/2, clock.py)
                 "wall_us": time.time_ns() // 1000}
        if bulk_key:
            hello["bulk_key"] = bulk_key
        if shm_name:
            hello["shm_seg"] = shm_name
        t0_mono = time.monotonic_ns()

        def abandon():
            conn.close()
            if bulk_h:
                lib.brpc_tpu_torch_fab_conn_close(bulk_h)
            self.drop_shm_segment(shm_h, shm_name)

        try:
            _send_frame(conn, _F_HELLO, json.dumps(hello).encode())
            fr = _recv_frame(conn)
        except OSError:
            abandon()
            self.forget_peer(owner)
            raise
        if fr is None or fr[0] != _F_HELLO_OK:
            msg = fr[1].decode() if fr else "connection closed"
            abandon()
            raise ConnectionRefusedError(f"fabric: {msg}")
        self._record_clock(owner, fr[1], t0_mono)
        try:
            echo = json.loads(fr[1]) if fr[1] else {}
        except ValueError:
            echo = {}
        conn.settimeout(None)
        sock = FabricSocket(conn, local_dev=client_dev,
                            remote_dev=target_dev, peer_pid=owner, node=self)
        if bulk_h:
            sock._bulk_is_uds = bulk_uds
            sock._attach_bulk(lib, bulk_h)
        if shm_h:
            if echo.get("shm"):
                sock._attach_shm(shm_lib, shm_h)
            else:
                # refused or failed at the server: nothing may leak
                self.drop_shm_segment(shm_h, shm_name)
        sock.start_io()
        return sock

    @staticmethod
    def _record_clock(owner: int, body: bytes, t0_mono: int) -> None:
        """The HELLO_OK echo's offset sample for ``owner``: the peer's
        wall minus our wall at the round trip's midpoint, bounded by half
        the round trip (+1 µs: a 0 bound would claim a perfection no
        measurement can prove)."""
        try:
            echo = json.loads(body) if body else {}
            if "wall_us" not in echo:
                return
            rtt_us = max(0, (time.monotonic_ns() - t0_mono) // 1000)
            from . import clock as _clock
            _clock.record(owner,
                          echo["wall_us"] - (echo["t0"] + rtt_us / 2.0),
                          rtt_us / 2.0 + 1.0)
        except (ValueError, KeyError, TypeError):
            pass          # a malformed echo: no estimate


class CollectiveSequencer:
    """Direction-spanning total order for one socket pair's device-plane
    transfers (``brpc_tpu/ici/fabric.py:944-1132``).

      * the socket's SERVER side is the order master: it assigns a dense
        sequence number to every transfer of both directions — its own
        sends at encode time, the client's the moment their descriptor
        arrives on the control read loop;
      * a master-side send carries its seq inside the kind-4 descriptor; a
        client-side send goes out with seq -1 and learns its slot from a
        ``_F_DPLANE_SEQ`` frame;
      * each side runs ONE executor thread admitting transfers strictly in
        seq order, so both processes handle transfer k only after 0..k-1:
        the receiver pulls in the master's order.

    The assignment stream is valid for one socket incarnation; ``epoch``
    is the pod epoch at creation (0 when no pod is joined)."""

    def __init__(self, sock, master: bool, epoch: int = 0):
        self.sock = sock
        self.master = master
        self.epoch = epoch
        self._cv = threading.Condition(threading.Lock())
        self._next_assign = 0
        self._next_exec = 0
        self._ready: Dict[int, object] = {}        # seq -> transfer
        self._unassigned: Dict[int, object] = {}   # uuid -> parked send
        self._closed = False
        # uuids in execution order (bounded)
        self.executed = collections.deque(maxlen=4096)
        self._thread = threading.Thread(
            target=self._run_loop,
            name=f"fabric_dplane_seq_{sock.remote_dev}", daemon=True)
        self._thread.start()

    def submit_local(self, t) -> Optional[int]:
        """Admit a transfer THIS side sends.  Returns the seq to encode —
        the assignment (master) or -1 (client, parked until the master's
        ``_F_DPLANE_SEQ``) — or None when the sequencer is closed."""
        with self._cv:
            if self._closed:
                return None
            if self.master:
                seq = self._next_assign
                self._next_assign += 1
                self._ready[seq] = t
                self._cv.notify_all()
            else:
                self._unassigned[t.uuid] = t
                seq = -1
        _dp.plane().annotate_transfer(
            t, f"seq assigned {seq}" if seq >= 0
            else "seq parked (awaiting master assignment)")
        return seq

    def submit_remote(self, t, seq: int) -> None:
        """Admit a transfer the PEER sends (its descriptor just arrived).
        The master assigns an unassigned (-1) one now and tells the peer:
        the control read loop's order makes the assignment deterministic."""
        assign = None
        with self._cv:
            if self._closed:
                _dp.plane().fail_transfer(
                    t, "sequencer closed before execution")
                return
            if seq < 0:
                if not self.master:
                    _dp.plane().fail_transfer(
                        t, "unassigned descriptor at non-master")
                    return
                seq = assign = self._next_assign
                self._next_assign += 1
            self._ready[seq] = t
            self._cv.notify_all()
        _dp.plane().annotate_transfer(t, f"seq assigned {seq}")
        if assign is not None:
            try:
                self.sock._ctrl_send(_F_DPLANE_SEQ,
                                     struct.pack("<Qq", t.uuid, assign))
            except OSError:
                pass      # control death tears the whole socket down

    def on_assignment(self, uuid: int, seq: int) -> None:
        """Client side: the master's slot for one of our parked sends."""
        with self._cv:
            t = self._unassigned.pop(uuid, None)
            if t is None:
                return
            if self._closed:
                _dp.plane().fail_transfer(
                    t, "sequencer closed before execution")
                return
            self._ready[seq] = t
            self._cv.notify_all()
        _dp.plane().annotate_transfer(t, f"seq assigned {seq} "
                                         "(master reply)")

    def _run_loop(self) -> None:
        leftovers: List = []
        while True:
            with self._cv:
                while not self._closed \
                        and self._next_exec not in self._ready:
                    self._cv.wait(0.5)
                if self._closed:
                    leftovers = (list(self._ready.values())
                                 + list(self._unassigned.values()))
                    self._ready.clear()
                    self._unassigned.clear()
                    break
                t = self._ready.pop(self._next_exec)
                self._next_exec += 1
            self._execute(t)
        for t in leftovers:
            _dp.plane().fail_transfer(t, "socket torn down before execution")

    def _execute(self, t) -> None:
        sock = self.sock
        if sock.failed or sock._peer_gone():
            _dp.plane().fail_transfer(t, "socket failed before execution")
            return
        _dp.plane().annotate_transfer(
            t, "seq admit queue_wait_us="
               f"{(time.monotonic_ns() - t.posted_ns) // 1000}")
        plan = _fi.fabric_active()
        if plan is not None:
            plan.on_plane_op(sock, "device")    # the SLOW injector
        try:
            sock._dplane_execute(t)
            self.executed.append(t.uuid)
        except Exception as e:
            # the transfer already failed; latch the plane
            sock._device_plane_down(f"execution failed: {e}")

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def join(self, timeout: float = 2.0) -> None:
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    def describe(self) -> dict:
        with self._cv:
            return {"master": self.master, "epoch": self.epoch,
                    "assigned": self._next_assign,
                    "executed": self._next_exec,
                    "queued": len(self._ready),
                    "awaiting_assignment": len(self._unassigned)}


class FabricSocket(CreditWindow, OrderedDelivery, Socket):
    """Cross-process ici socket: the control TCP connection, the credit
    window of the in-process IciSocket and the sequenced device leg."""

    def __init__(self, conn: _pysocket.socket, local_dev: int,
                 remote_dev: int, peer_pid: int, node: FabricNode,
                 window_bytes: Optional[int] = None,
                 fresh_info: bool = False):
        self.mesh = node.mesh
        super().__init__(remote_side=self.mesh.endpoint(remote_dev))
        self.local_side = self.mesh.endpoint(local_dev)
        self.local_dev = local_dev
        self.remote_dev = remote_dev
        self.peer_pid = peer_pid
        self.node = node
        self._conn = conn
        self._conn_wlock = threading.Lock()
        self._inbox = IOBuf()
        self._inbox_lock = threading.Lock()
        self.read_chunk_hint = 1 << 26    # _do_read cuts, never allocates
        # full RPC messages are queued to tasklets, so a handler never
        # stalls the control channel's CREDIT/PULLED processing
        self.queue_last_message = True
        self._consumed_unacked = 0        # credits not yet returned
        self._peer_closed = False         # reader-visible EOF (ordered)
        self._conn_dead = False           # writer-visible death
        self._fin_code = 0                # the peer's close code
        self._init_window(window_bytes)
        self._init_delivery()
        self._reader: Optional[threading.Thread] = None
        info = node.peer_info(peer_pid, fresh=fresh_info)
        self._peer_contact = info
        self.peer_os_pid = int(info.get("os_pid", 0))
        self._dplane_peer = info.get("dplane3", 0) >= 3
        self._ipc_peer = (info.get(_ipc.HANDSHAKE_KEY)
                          == _ipc.HANDSHAKE_VERSION)
        self._plane_device = node.device_health(peer_pid)
        self._dplane_lock = threading.Lock()
        self._dplane_seq: Optional[CollectiveSequencer] = None   # lazy
        self._dplane_closed = False
        # sends pinned until the peer's PULLED: uuid -> transfer
        self._staged: Dict[int, _dp.DeviceTransfer] = {}
        self._staged_lock = threading.Lock()
        self._importer = _ipc.Importer()
        self.dplane_bytes_sent = 0
        self.dplane_bytes_recv = 0
        # the same-host tiers.  _bulk_lock guards both planes' handles,
        # epochs, pending revivals and byte counters (writers of several
        # streams share the socket), and is the lock their health records
        # decide under, so a death and a handle swap serialize
        self._bulk_lock = threading.Lock()
        self._bulk = 0                         # the bulk conn's handle
        self._blib = None
        self._bulk_epoch = 0                   # attachments so far
        self.bulk_bytes_sent = 0               # cumulative over epochs
        self.bulk_bytes_claimed = 0
        self._bulk_is_uds = False              # the route row's label
        self._reestab_pending: Optional[Tuple] = None     # (lib, handle)
        self._reestab_ok = False
        self._reestab_evt = threading.Event()
        self._shm = 0                          # the ring's handle
        self._shm_dead = 0                     # a retired ring, claim-only
        self._shmlib = None
        self._shm_epoch = 0
        self._shm_ring_bytes = 0               # per-direction capacity
        self._shm_stripes = 1
        self._shm_dead_stripes = 1
        # unary frames round-robin the stripes; streams pin one by id
        self._shm_rr = itertools.count().__next__
        self.shm_bytes_sent = 0
        self.shm_bytes_claimed = 0
        self._shm_peer = node.shm_peer_ok(peer_pid)
        self._shm_reestab_pending: Optional[Tuple] = None  # (lib, h, name)
        self._shm_reestab_ok = False
        self._shm_reestab_evt = threading.Event()

        def gone():
            # a quiesced node ends its probers too: no revival may run
            # into the interpreter's exit
            return (self.failed or self._peer_gone()
                    or getattr(node, "_shutdown", False))

        self._plane_bulk = _ph.register_plane(
            "bulk", self._bulk_lock,
            probe=lambda n: bool(self._bulk_alive()),
            gate=lambda: not (self.is_server_side or gone()),
            prober=self._bulk_revive_attempt,
            attached=lambda: bool(self._bulk),
            dead=gone, thread_name="fabric_bulk_revive",
            seed=self.id ^ 0x5DEECE66D)
        self._plane_shm = _ph.register_plane(
            "shm", self._bulk_lock,
            probe=self.shm_route_usable,
            gate=lambda: not (self.is_server_side or gone()
                              or not self._shm_peer),
            prober=self._shm_revive_attempt,
            attached=lambda: bool(self._shm),
            dead=gone, thread_name="fabric_shm_revive",
            seed=self.id ^ 0x73686D)
        self._planes = {"bulk": self._plane_bulk, "shm": self._plane_shm}

    # ---- device plane ------------------------------------------------
    def dplane_eligible(self, nbytes: int) -> bool:
        """A DEVICE payload of ``nbytes`` must cross as kind 4: the flags,
        the peer's adverts and the plane's threshold and platform say so.
        (Whether the plane is UP is not asked here: a down plane refuses
        the payload rather than sending it inline.)"""
        return (self._dplane_peer and self._ipc_peer
                and _dp.eligible(nbytes, self.mesh, self.local_dev,
                                 self.remote_dev))

    def _dplane_sequencer(self) -> Optional[CollectiveSequencer]:
        with self._dplane_lock:
            if self._dplane_closed:
                return None
            if self._dplane_seq is None:
                from .pod import Pod
                pod = Pod.current()
                epoch = pod.epoch() if pod is not None else 0
                self._dplane_seq = CollectiveSequencer(
                    self, master=self.is_server_side, epoch=epoch)
            return self._dplane_seq

    def _device_plane_down(self, reason: str) -> None:
        if self._plane_device.mark_down(reason):
            log.warning("fabric %s: device plane down (%s); device "
                        "payloads fail until the re-probe in %.1fs",
                        self.remote_side, reason, DEVICE_RETRY_S)

    def _post_device(self, arr, block) -> bytes:
        """Post, export and sequence one DEVICE payload; returns its
        kind-4 chunk.  Raises IpcPullError (EINTERNAL) when refused, and
        ConnectionError when the connection is already over."""
        plane = _dp.plane()
        if not self._plane_device.usable():
            raise _ipc.IpcPullError(
                f"device plane to process {self.peer_pid} is down "
                f"({self._plane_device.reason})")
        src = self.mesh.rank_of(arr)
        if src < 0 or src == self.remote_dev:
            # unowned, or placed here for the peer's own rank (a fan-out
            # mapper's row for its member): it lives in this process,
            # whose rank sends it
            src = self.local_dev
        try:
            t = plane.post_send(arr, src, self.remote_dev, mesh=self.mesh,
                                uuid=self.node.next_uuid(), remote=True,
                                socket=self)
        except _dp.DevicePlaneError as e:
            self._device_plane_down(str(e))
            raise _ipc.IpcPullError(str(e)) from None
        t.add_source_release(getattr(block, "on_send_complete", None))
        try:
            t.remote = _ipc.export_row(arr)
        except Exception as e:
            plane.fail_transfer(t, str(e))
            self._device_plane_down(str(e))
            raise _ipc.IpcPullError(str(e)) from None
        with self._staged_lock:
            self._staged[t.uuid] = t
        seqr = self._dplane_sequencer()
        seq = seqr.submit_local(t) if seqr is not None else None
        if seq is None:
            # the sequencer closes only when the connection is over: the
            # write fails as on any dead connection (EFAILEDSOCKET, which
            # a channel retries), not as a refusal of the device leg
            self._unstage(t.uuid, "device-plane sequencer closed")
            raise ConnectionError("device-plane sequencer closed: the "
                                  "connection is over")
        return encode_device_descriptor(t.uuid, t.nbytes, src, seq,
                                        t.trace_id, t.parent_span_id,
                                        t.remote.ext)

    def _dplane_execute(self, t) -> None:
        """At the transfer's slot: the receiver pulls; the sender's half
        has nothing to run (its row is read by the peer, and it completes
        at PULLED)."""
        if t.source_array() is not None or t.state != _dp.POSTED:
            return
        plane = _dp.plane()
        try:
            row, ev, release = self._importer.source(t.remote, t.nbytes)
            try:
                plane.execute_remote(t, row, ev)
            finally:
                del row
                if release is not None:
                    release()
        except Exception as e:
            # the sender hears the reason first: failing the transfer
            # fails this socket (its frame can never be delivered)
            reason = f"pull failed: {e}"
            try:
                self._ctrl_send(_F_PULL_ERR, struct.pack(
                    "<QI", t.uuid, errors.EINTERNAL) + reason.encode())
            except OSError:
                pass
            plane.fail_transfer(t, reason)
            raise
        uuid = t.uuid

        def pulled(rc: int) -> None:
            if rc == 0:
                try:
                    self._ctrl_send(_F_PULLED, struct.pack("<Q", uuid))
                except OSError:
                    pass

        t.add_done_callback(pulled)

    def _unstage(self, uuid: int, reason: str) -> None:
        with self._staged_lock:
            t = self._staged.pop(uuid, None)
        if t is not None:
            _dp.plane().fail_transfer(t, reason)
            t.remote.release()

    def _close_dplane(self) -> None:
        with self._dplane_lock:
            self._dplane_closed = True
            seqr = self._dplane_seq
        if seqr is not None:
            seqr.close()

    def describe_dplane_sequencer(self) -> Optional[dict]:
        with self._dplane_lock:
            seqr = self._dplane_seq
        return None if seqr is None else seqr.describe()

    def describe_planes(self) -> dict:
        """Per-plane health snapshots for the /ici page."""
        out = {name: rec.snapshot() for name, rec in self._planes.items()}
        out["device"] = self._plane_device.snapshot()
        return out

    def plane_usable(self, plane: str, nbytes: int = 0) -> bool:
        """The route table's one gate: the plane's health record first (a
        down plane is skipped without a probe), then its capability probe
        (a live native conn, a ring the payload fits)."""
        rec = self._planes.get(plane)
        return rec is not None and rec.usable(nbytes)

    # ---- the bulk conn: attach, degrade, revive --------------------------
    def _attach_bulk(self, lib, handle: int) -> None:
        """Bind the bulk conn (0: none).  A re-attach closes the stale
        handle and bumps the epoch; a fault plan may poison the fresh conn
        here."""
        with self._bulk_lock:
            old, self._bulk = self._bulk, handle
            self._blib = lib
            if handle:
                self._bulk_epoch += 1
        if old and lib is not None:
            lib.brpc_tpu_torch_fab_conn_close(old)
        if handle:
            lib.brpc_tpu_torch_fab_set_peer(handle, self.peer_pid)
            plan = _fi.fabric_active()
            if plan is not None:
                plan.on_bulk_attach(self, lib, handle)
            # an initial attach finds the record UP and counts nothing
            self._plane_bulk.revived()

    def bulk_epoch(self) -> int:
        with self._bulk_lock:
            return self._bulk_epoch

    def _bulk_alive(self) -> int:
        """The bulk handle when usable, else 0.  A dead conn is degraded
        here, at a frame boundary, before any descriptor names it."""
        with self._bulk_lock:
            h, lib = self._bulk, self._blib
        if not h:
            return 0
        if lib.brpc_tpu_torch_fab_alive(h):
            return h
        self._bulk_plane_down("bulk conn dead at frame boundary")
        return 0

    def bulk_plane_failed(self) -> None:
        """A stream's bulk claim failed (:mod:`..rpc.stream`): that stream
        fails, the socket survives, the plane degrades and revives."""
        self._bulk_plane_down("bulk claim failed")

    def shm_plane_failed(self) -> None:
        """A stream's shm claim failed: as :meth:`bulk_plane_failed`."""
        self._shm_plane_down("shm claim failed")

    def _bulk_plane_down(self, reason: str, notify: bool = True) -> None:
        with self._bulk_lock:
            h, self._bulk = self._bulk, 0
            lib = self._blib
        if not h:
            return                      # already down, or never bound
        if lib is not None:
            lib.brpc_tpu_torch_fab_conn_close(h)
        log.warning("fabric %s: bulk plane down (%s); inline fallback",
                    self.remote_side, reason)
        self._plane_bulk.mark_down(reason)
        if notify:
            self._plane_notify_down("bulk")
        self._plane_bulk.kick()         # the client side revives

    def _plane_notify_down(self, which: str) -> None:
        """Tell the peer the plane died so it degrades too (the receiving
        end degrades without notifying back)."""
        if self._peer_gone():
            return
        try:
            self._ctrl_send(
                _F_BULK_DOWN if which == "bulk" else _F_SHM_DOWN, b"")
        except OSError:
            pass

    def _bulk_revive_attempt(self) -> bool:
        """One attempt, run by the prober's loop: dial and park a fresh
        conn and ask the server to claim it.  The attach happens on the
        read loop (:meth:`_on_bulk_reply`), so descriptors stay ordered."""
        h, key, lib, is_uds = self.node.dial_bulk(self.peer_pid,
                                                  self._peer_contact)
        if not h:
            return False
        self._bulk_is_uds = is_uds
        self._reestab_evt.clear()
        self._reestab_ok = False
        with self._bulk_lock:
            self._reestab_pending = (lib, h)
        try:
            self._ctrl_send(_F_BULK_REESTABLISH,
                            json.dumps({"bulk_key": key}).encode())
            ok = self._reestab_evt.wait(5.0) and self._reestab_ok
        except OSError:
            ok = False
        if ok:
            log.info("fabric %s: bulk plane re-established (epoch %d)",
                     self.remote_side, self.bulk_epoch())
            return True
        with self._bulk_lock:
            pending, self._reestab_pending = self._reestab_pending, None
        if pending is not None:
            lib.brpc_tpu_torch_fab_conn_close(h)
        return False

    def _on_bulk_reestablish(self, req: dict) -> None:
        """Server side, on the read loop: claim the conn the client parked
        and attach it, before any descriptor that uses it."""
        key = req.get("bulk_key")
        node = self.node
        ok = False
        plan = _fi.fabric_active()
        if plan is not None and plan.on_bulk_handshake(self):
            node._reap_parked_bulk(key)          # refuse deterministically
        elif key and node._bulk_listener and node._bulk_lib is not None:
            h = node._bulk_lib.brpc_tpu_torch_fab_accept(
                node._bulk_listener, key.encode(), 2_000_000)
            if h:
                self._attach_bulk(node._bulk_lib, h)
                ok = True
        try:
            self._ctrl_send(_F_BULK_OK if ok else _F_BULK_ERR, b"")
        except OSError:
            pass

    def _on_bulk_reply(self, ok: bool) -> None:
        """Client side, on the read loop: the server's OK/ERR.  A
        descriptor after OK on the serial control channel always finds the
        new handle bound."""
        with self._bulk_lock:
            pending, self._reestab_pending = self._reestab_pending, None
        if ok and pending is not None:
            self._attach_bulk(*pending)
        elif pending is not None:
            pending[0].brpc_tpu_torch_fab_conn_close(pending[1])
            ok = False
        self._reestab_ok = ok and pending is not None
        self._reestab_evt.set()

    def _close_bulk(self) -> None:
        """Socket teardown of the bulk conn, no revival."""
        with self._bulk_lock:
            h, self._bulk = self._bulk, 0
            pending, self._reestab_pending = self._reestab_pending, None
            lib = self._blib
        if h and lib is not None:
            lib.brpc_tpu_torch_fab_conn_close(h)
        if pending is not None:
            pending[0].brpc_tpu_torch_fab_conn_close(pending[1])
        self._reestab_evt.set()        # unblock a parked revival

    # ---- the shm ring: attach, degrade, revive ---------------------------
    def _attach_shm(self, lib, handle: int) -> None:
        """Bind the ring pair (0: none); as :meth:`_attach_bulk`."""
        ring_bytes, stripes = 0, 1
        if handle:
            st = (ctypes.c_uint64 * 6)()
            if lib.brpc_tpu_torch_shm_stats(handle, st, 6) == 6:
                ring_bytes = int(st[5])
            stripes = int(lib.brpc_tpu_torch_shm_stripes(handle)) or 1
        with self._bulk_lock:
            old, self._shm = self._shm, handle
            self._shmlib = lib
            if handle:
                self._shm_epoch += 1
                self._shm_ring_bytes = ring_bytes
                self._shm_stripes = stripes
        if old and lib is not None:
            lib.brpc_tpu_torch_shm_close(old)
        if handle:
            plan = _fi.fabric_active()
            if plan is not None:
                plan.on_shm_attach(self, lib, handle)
            self._plane_shm.revived()

    def shm_bound(self) -> bool:
        with self._bulk_lock:
            return bool(self._shm)

    def shm_epoch(self) -> int:
        with self._bulk_lock:
            return self._shm_epoch

    def _shm_alive(self) -> int:
        """The ring's handle when usable, else 0 (a dead ring degrades
        here, at a frame boundary)."""
        with self._bulk_lock:
            h, lib = self._shm, self._shmlib
        if not h:
            return 0
        if lib.brpc_tpu_torch_shm_alive(h):
            return h
        self._shm_plane_down("shm ring dead at frame boundary")
        return 0

    def shm_route_usable(self, nbytes: int) -> bool:
        """A live ring the payload is sure to fit: at most half the ring
        (a larger frame may land at a wrap where it never fits).  An
        oversize payload skips the ring without degrading it."""
        with self._bulk_lock:
            h, ring = self._shm, self._shm_ring_bytes
        if not h:
            return False
        if ring and nbytes + 48 > ring // 2:
            return False
        return bool(self._shm_alive())

    def _shm_plane_down(self, reason: str, notify: bool = True) -> None:
        with self._bulk_lock:
            h, self._shm = self._shm, 0
            lib = self._shmlib
            old_dead = 0
            if h:
                # the retired ring stays claimable (marked dead, not
                # closed): descriptors already sent name bytes published
                # in it.  At most one retired ring: a second death closes
                # the first
                old_dead, self._shm_dead = self._shm_dead, h
                self._shm_dead_stripes = self._shm_stripes
                self._shm_stripes = 1
        if not h:
            return
        if lib is not None:
            lib.brpc_tpu_torch_shm_mark_dead(h)
            if old_dead:
                lib.brpc_tpu_torch_shm_close(old_dead)
        log.warning("fabric %s: shm ring down (%s); bulk tier engaged",
                    self.remote_side, reason)
        self._plane_shm.mark_down(reason)
        if notify:
            self._plane_notify_down("shm")
        self._plane_shm.kick()

    def _shm_revive_attempt(self) -> bool:
        """One attempt: create a fresh segment and ask the server to
        attach it; our own attach happens on the read loop."""
        h, name, lib = self.node.create_shm_segment()
        if not h:
            return False
        self._shm_reestab_evt.clear()
        self._shm_reestab_ok = False
        with self._bulk_lock:
            self._shm_reestab_pending = (lib, h, name)
        try:
            self._ctrl_send(_F_SHM_REESTABLISH,
                            json.dumps({"shm_seg": name}).encode())
            ok = self._shm_reestab_evt.wait(5.0) and self._shm_reestab_ok
        except OSError:
            ok = False
        if ok:
            log.info("fabric %s: shm ring re-established (epoch %d)",
                     self.remote_side, self.shm_epoch())
            return True
        with self._bulk_lock:
            pending, self._shm_reestab_pending = \
                self._shm_reestab_pending, None
        if pending is not None:
            self.node.drop_shm_segment(pending[1], pending[2])
        return False

    def _on_shm_reestablish(self, req: dict) -> None:
        """Server side, on the read loop: attach the client's fresh
        segment and unlink it."""
        name = req.get("shm_seg")
        node = self.node
        ok = False
        plan = _fi.fabric_active()
        if plan is not None and plan.on_shm_handshake(self):
            pass                                 # refuse deterministically
        elif name and node._shm_ok and node._shm_lib is not None \
                and _flags.get_flag("ici_fabric_shm"):
            h = node._shm_lib.brpc_tpu_torch_shm_attach(name.encode())
            if h:
                node._shm_lib.brpc_tpu_torch_shm_unlink(name.encode())
                self._attach_shm(node._shm_lib, h)
                ok = True
        try:
            self._ctrl_send(_F_SHM_OK if ok else _F_SHM_ERR, b"")
        except OSError:
            pass

    def _on_shm_reply(self, ok: bool) -> None:
        with self._bulk_lock:
            pending, self._shm_reestab_pending = \
                self._shm_reestab_pending, None
        if ok and pending is not None:
            self._attach_shm(pending[0], pending[1])
        elif pending is not None:
            self.node.drop_shm_segment(pending[1], pending[2])
            ok = False
        self._shm_reestab_ok = ok and pending is not None
        self._shm_reestab_evt.set()

    def _on_plane_frame(self, which: str, op: int, body: bytes) -> None:
        """One read-loop row for both planes (``_PLANE_FRAMES``).  op 0:
        the peer saw the plane die first, degrade without echoing; op 1:
        the client parked or created a fresh plane, the server attaches
        it here; op 2/3: the server's OK/ERR to our pending attempt."""
        bulk = which == "bulk"
        if op == 0:
            (self._bulk_plane_down if bulk else self._shm_plane_down)(
                f"peer reported {which} death", notify=False)
        elif op == 1:
            req = json.loads(body)
            (self._on_bulk_reestablish if bulk
             else self._on_shm_reestablish)(req)
        else:
            (self._on_bulk_reply if bulk else self._on_shm_reply)(op == 2)

    def _close_shm(self) -> None:
        """Socket teardown of the ring, no revival.  Claimed views stay
        readable: the native side defers the unmap to the last release."""
        with self._bulk_lock:
            h, self._shm = self._shm, 0
            dead_h, self._shm_dead = self._shm_dead, 0
            pending, self._shm_reestab_pending = \
                self._shm_reestab_pending, None
            lib = self._shmlib
        if lib is not None:
            if h:
                lib.brpc_tpu_torch_shm_close(h)
            if dead_h:
                lib.brpc_tpu_torch_shm_close(dead_h)
        if pending is not None:
            self.node.drop_shm_segment(pending[1], pending[2])
        self._shm_reestab_evt.set()

    def describe_shm(self) -> Optional[dict]:
        """The ring's row of the /ici page: byte totals, epoch, stripes,
        occupancy and doorbell waits."""
        with self._bulk_lock:
            h, lib = self._shm, self._shmlib
            stripes = self._shm_stripes
            out = {"epoch": self._shm_epoch,
                   "bytes_sent": self.shm_bytes_sent,
                   "bytes_claimed": self.shm_bytes_claimed,
                   "ring_bytes": self._shm_ring_bytes,
                   "stripes": stripes}
        if not h and not out["epoch"]:
            return None
        if h and lib is not None:
            st = (ctypes.c_uint64 * 6)()
            if lib.brpc_tpu_torch_shm_stats(h, st, 6) == 6:
                out.update({"tx_occupancy": int(st[2]),
                            "rx_occupancy": int(st[3]),
                            "doorbell_waits": int(st[4])})
            if stripes > 1:
                per = []
                for i in range(stripes):
                    if lib.brpc_tpu_torch_shm_stripe_stats(h, i, st, 6) == 6:
                        per.append({"bytes_out": int(st[0]),
                                    "bytes_in": int(st[1]),
                                    "tx_occupancy": int(st[2]),
                                    "rx_occupancy": int(st[3]),
                                    "doorbell_waits": int(st[4])})
                out["stripe_stats"] = per
        return out

    def ipc_stats(self) -> dict:
        return {"opens": self._importer.opens, "hits": self._importer.hits,
                "mapped": self._importer.mapped(),
                "staged": self.inflight_send_blocks()}

    # ---- io --------------------------------------------------------------
    def start_io(self) -> None:
        self._reader = threading.Thread(target=self._read_loop,
                                        name="fabric_read", daemon=True)
        self._reader.start()

    def quiesce_reader(self, timeout: float = 2.0) -> None:
        """Sever the control conn and join the reader and the sequencer
        (the exit-time quiesce: no fabric thread may be cut off inside a
        torch call while the interpreter finalizes)."""
        try:
            self._conn.shutdown(_pysocket.SHUT_RDWR)
        except OSError:
            pass
        r = self._reader
        if r is not None and r.is_alive() \
                and r is not threading.current_thread():
            r.join(timeout)
        with self._dplane_lock:
            seqr = self._dplane_seq
        if seqr is not None:
            seqr.close()
            seqr.join(timeout)

    # ---- lame duck (GOODBYE) -------------------------------------------
    def send_goodbye(self) -> None:
        """Server drain: the peer pulls this endpoint from its balancers
        now, not at the next health-check probe."""
        if self._peer_gone():
            return
        try:
            self._ctrl_send(_F_GOODBYE, b"")
        except OSError:
            pass

    def _on_goodbye(self) -> None:
        self.logoff = True
        from ..rpc import lameduck
        lameduck.notify_peer_draining(self.remote_side)

    def inflight_send_blocks(self) -> int:
        with self._staged_lock:
            return len(self._staged)

    def _peer_gone(self) -> bool:
        return self._peer_closed or self._conn_dead

    # ---- write path ------------------------------------------------------
    def _ctrl_send(self, ftype: int, body: bytes) -> None:
        """Every outbound control frame passes here: the one place the
        fault plan drops a frame or severs the control connection."""
        plan = _fi.fabric_active()
        if plan is not None:
            action = plan.on_control_send(self)
            if action == _fi.DROP:
                return
            if action == _fi.ERROR:
                # both directions: the read loop sees the reset and runs
                # the connection-over path, as after a peer's RST
                try:
                    self._conn.shutdown(_pysocket.SHUT_RDWR)
                except OSError:
                    pass
                raise ConnectionError("fabric control channel: "
                                      "injected sever")
        with self._conn_wlock:
            _send_frame(self._conn, ftype, body)

    def _do_write(self, data: IOBuf) -> int:
        n = self._consume_window(len(data))
        if n < 0:
            return -1
        frame = data.cut(n)
        body = self._encode_data(frame)
        try:
            self._ctrl_send(_F_DATA, body)
        except OSError as e:
            raise ConnectionError(f"fabric control channel: {e}")
        return n

    def _encode_data(self, frame: IOBuf) -> bytes:
        """Serialize a frame.  Each payload's route comes from the route
        table (:mod:`.route`): a DEVICE ref the device plane must carry is
        posted as kind 4 (its bytes are pulled by the receiver) and has no
        other route; host blobs and every other DEVICE ref try the shm
        ring (kinds 6/5), the bulk conn (kinds 3/2), then inline (kind 0).
        A failed send degrades its plane and falls through to the next
        route of the same frame: nothing is committed to the control
        stream until its bytes are with a transport."""
        out = [b""]
        nchunks = 0
        pending_host: List[bytes] = []

        def flush_host():
            nonlocal nchunks
            if not pending_host:
                return
            blob = b"".join(pending_host)
            pending_host.clear()
            nchunks += 1
            for rt in _route.candidates(self, _route.HOST, len(blob)):
                if rt == _route.SHM:
                    uuid = self.shm_tag_uuid(self.node.next_uuid())
                    try:
                        self._shm_send(uuid, blob)
                    except _ShmOversize:
                        continue
                    except ConnectionError:
                        self._shm_plane_down("shm send failed mid-encode")
                        continue
                    out.append(struct.pack("<BQQ", 6, uuid, len(blob)))
                    _route.record(self, rt, len(blob))
                    return
                if rt == _route.BULK:
                    uuid = self.node.next_uuid()
                    try:
                        self._bulk_send(uuid, blob)
                    except ConnectionError:
                        self._bulk_plane_down("bulk send failed mid-encode")
                        continue
                    out.append(struct.pack("<BQQ", 3, uuid, len(blob)))
                    _route.record(self, rt, len(blob))
                    return
                break                              # INLINE
            out.append(struct.pack("<BI", 0, len(blob)))
            out.append(blob)
            _route.record(self, _route.INLINE, len(blob))

        for i in range(frame.backing_block_num()):
            r = frame.backing_block(i)
            if r.block.kind != DEVICE:
                pending_host.append(
                    bytes(r.block.host_view(r.offset, r.length)))
                continue
            arr = r.block.data
            if r.offset or r.length != arr.shape[0]:
                arr = arr[r.offset:r.offset + r.length]
            routes = _route.candidates(self, _route.DEVICE, r.length)
            if routes == [_route.DEVICE]:
                desc = self._post_device(arr, r.block)
                flush_host()
                out.append(desc)
                nchunks += 1
                self.dplane_bytes_sent += r.length
                _route.record(self, _route.DEVICE, r.length)
                continue
            kind = 0
            for rt in routes:
                if rt not in (_route.SHM, _route.BULK):
                    break                          # INLINE
                # one device-to-host copy stages the payload (none for a
                # tensor already on the host)
                host = arr.detach().to("cpu").contiguous()
                uuid = self.node.next_uuid()
                try:
                    if rt == _route.SHM:
                        uuid = self.shm_tag_uuid(uuid)
                        self._shm_send(uuid, host)
                        kind = 5
                    else:
                        self._bulk_send(uuid, host)
                        kind = 2
                except _ShmOversize:
                    continue
                except ConnectionError:
                    if rt == _route.SHM:
                        self._shm_plane_down("shm send failed mid-encode")
                    else:
                        self._bulk_plane_down("bulk send failed mid-encode")
                    continue
                _route.record(self, rt, r.length)
                # synchronous-send custody: the kernel or the ring holds a
                # copy, the source block may be reused now
                cb = getattr(r.block, "on_send_complete", None)
                if cb is not None:
                    try:
                        cb()
                    except Exception:
                        pass
                break
            if kind == 0:
                # no fast plane: the payload crosses as host bytes on the
                # control channel (Block.host_view)
                pending_host.append(
                    bytes(r.block.host_view(r.offset, r.length)))
                continue
            flush_host()
            out.append(encode_array_descriptor(kind, uuid, r.length))
            nchunks += 1
        flush_host()
        out[0] = struct.pack("<I", nchunks)
        return b"".join(out)

    def _bulk_send(self, uuid: int, data) -> None:
        """Blocking bulk-conn send of bytes or a contiguous CPU tensor
        (ctypes drops the GIL for the native write)."""
        ptr, n, keep = _host_ptr(data)
        with self._bulk_lock:
            h, lib = self._bulk, self._blib
        rc = lib.brpc_tpu_torch_fab_send(h, uuid, ptr, n) if h else -1
        del keep
        if rc != 0:
            raise ConnectionError("fabric bulk channel closed")
        with self._bulk_lock:
            self.bulk_bytes_sent += n

    def shm_tag_uuid(self, uuid: int,
                     affinity: Optional[int] = None) -> int:
        """Stamp the chosen stripe into the uuid's top byte, which the
        descriptor carries to the claimer.  ``affinity`` (a stream's id)
        pins a stripe; unary frames round-robin.  A 1-stripe ring leaves
        the uuid as it is."""
        with self._bulk_lock:
            n = self._shm_stripes
        if n <= 1:
            return uuid
        stripe = (affinity if affinity is not None else self._shm_rr()) % n
        return (uuid & ~(0xff << _SHM_STRIPE_SHIFT)) | \
            (stripe << _SHM_STRIPE_SHIFT)

    @staticmethod
    def _shm_stripe_of(uuid: int, nstripes: int) -> int:
        """The stripe a tagged uuid names, clamped into range."""
        if nstripes <= 1:
            return 0
        return min(uuid >> _SHM_STRIPE_SHIFT, nstripes - 1)

    def _shm_send(self, uuid: int, data) -> None:
        """Blocking ring send of bytes or a contiguous CPU tensor (the GIL
        is dropped for the copy; a full ring parks on its doorbell for at
        most ``ici_shm_send_timeout_s``).  Raises _ShmOversize when the
        frame can never fit (route elsewhere) and ConnectionError on death
        or timeout (degrade)."""
        plan = _fi.fabric_active()
        if plan is not None:
            plan.on_plane_op(self, "shm")      # the SLOW injector
        ptr, n, keep = _host_ptr(data)
        with self._bulk_lock:
            h, lib, stripes = self._shm, self._shmlib, self._shm_stripes
        timeout_us = int(_flags.get_flag("ici_shm_send_timeout_s") * 1e6)
        if not h:
            rc = -1
        elif stripes > 1:
            stripe = self._shm_stripe_of(uuid, stripes)
            rc = lib.brpc_tpu_torch_shm_send2(h, stripe, uuid, ptr, n,
                                              timeout_us)
            if rc == 0:
                _route.record_shm_stripe(stripe, n)
        else:
            rc = lib.brpc_tpu_torch_shm_send(h, uuid, ptr, n, timeout_us)
        del keep
        if rc == -3:
            raise _ShmOversize()
        if rc != 0:
            raise ConnectionError("fabric shm ring closed")
        with self._bulk_lock:
            self.shm_bytes_sent += n

    # ---- the stream fast plane -------------------------------------------
    # A stream DATA frame of at least ici_stream_bulk_threshold posts its
    # payload here (rpc/stream.py): the bytes ride the ring or the bulk
    # conn under a reserved uuid, and a 16-byte descriptor the control
    # channel.  Custody is synchronous-send, delivery zero-copy host
    # bytes, as for kinds 2/3/5/6.

    def stream_fast_begin(self, nbytes: int,
                          affinity: Optional[int] = None
                          ) -> Tuple[int, Optional[str]]:
        """Route one stream DATA frame: (uuid, "shm" or "bulk"), or (0,
        None) to stay inline.  A dead plane is found here, before the
        descriptor goes out, so the frame rides the next tier."""
        for rt in _route.candidates(self, _route.STREAM, nbytes):
            if rt == _route.SHM:
                return self.shm_tag_uuid(self.node.next_uuid(),
                                         affinity), rt
            if rt == _route.BULK:
                return self.node.next_uuid(), rt
            break
        return 0, None

    @staticmethod
    def _gather_blocks(frame: IOBuf):
        """(ptrs, lens, n, total, keep) for a gather send; keep pins the
        block memory until the native call returns."""
        nblocks = frame.backing_block_num()
        ptrs = (ctypes.c_void_p * max(nblocks, 1))()
        lens = (ctypes.c_uint64 * max(nblocks, 1))()
        keep = []
        n = total = 0
        for i in range(nblocks):
            r = frame.backing_block(i)
            if not r.length:
                continue
            if r.block.kind == DEVICE:
                t = r.block.data[r.offset:r.offset + r.length]
                t = t.detach().to("cpu").contiguous()
                ptr = t.data_ptr()
            else:
                import numpy as np
                t = np.frombuffer(r.block.host_view(r.offset, r.length),
                                  dtype=np.uint8)
                ptr = t.ctypes.data
            keep.append(t)
            ptrs[n] = ptr
            lens[n] = r.length
            total += r.length
            n += 1
        return ptrs, lens, n, total, keep

    def stream_fast_send(self, route: str, uuid: int, frame: IOBuf) -> None:
        """Gather-send the frame's blocks as one uuid-tagged frame on the
        chosen plane (the native call drops the GIL; synchronous-send
        custody).  A failure degrades the plane and raises."""
        ptrs, lens, n, total, keep = self._gather_blocks(frame)
        if route == _route.SHM:
            with self._bulk_lock:
                h, lib, stripes = self._shm, self._shmlib, self._shm_stripes
            timeout_us = int(
                _flags.get_flag("ici_shm_send_timeout_s") * 1e6)
            if not h:
                rc = -1
            elif stripes > 1:
                stripe = self._shm_stripe_of(uuid, stripes)
                rc = lib.brpc_tpu_torch_shm_sendv2(h, stripe, uuid, ptrs,
                                                   lens, n, timeout_us)
                if rc == 0:
                    _route.record_shm_stripe(stripe, total)
            else:
                rc = lib.brpc_tpu_torch_shm_sendv(h, uuid, ptrs, lens, n,
                                                  timeout_us)
            del keep
            if rc != 0:
                self._shm_plane_down("shm sendv failed")
                raise ConnectionError("fabric shm ring closed")
            with self._bulk_lock:
                self.shm_bytes_sent += total
            _route.record(self, _route.SHM, total)
            return
        with self._bulk_lock:
            h, lib = self._bulk, self._blib
        rc = lib.brpc_tpu_torch_fab_sendv(h, uuid, ptrs, lens, n) \
            if h else -1
        del keep
        if rc != 0:
            # the descriptor is already on the control channel: the peer's
            # claim fails and closes that stream; the socket only degrades
            self._bulk_plane_down("bulk sendv failed")
            raise ConnectionError("fabric bulk channel closed")
        with self._bulk_lock:
            self.bulk_bytes_sent += total
        _route.record(self, _route.BULK, total)

    def stream_fast_abort(self, route: Optional[str]) -> None:
        """Sever the plane a descriptor went out on whose payload never
        will, so the peer's claim fails at once (and closes that stream)
        instead of waiting out the claim timeout."""
        if route == _route.SHM:
            self._shm_plane_down("stream shm abort")
        else:
            self._bulk_plane_down("stream bulk abort")

    def stream_bulk_claim(self, uuid: int, length: int) -> IOBuf:
        """A stream frame's bulk bytes as a zero-copy IOBuf (a USER block
        over the native buffer, released when its last ref dies)."""
        buf = IOBuf()
        buf.append_user_data(memoryview(self._claim_zero_copy(uuid, length)))
        with self._bulk_lock:
            self.bulk_bytes_claimed += length
        return buf

    def stream_shm_claim(self, uuid: int, length: int) -> IOBuf:
        """A stream frame's ring bytes as a zero-copy IOBuf (the slot
        retires when its last ref dies)."""
        buf = IOBuf()
        buf.append_user_data(
            memoryview(self._shm_claim_zero_copy(uuid, length)))
        return buf

    # ---- claims ----------------------------------------------------------
    def _bulk_claim(self, uuid: int):
        """(ptr, len, handle, lib) of one bulk frame.  A frame may trail
        its descriptor (two connections, no cross order): the claim
        waits up to ``ici_bulk_claim_timeout_s``.  The caller releases
        against the returned handle (the conn the frame came from)."""
        with self._bulk_lock:
            h, lib = self._bulk, self._blib
        out, olen = _u8p(), ctypes.c_uint64()
        timeout_us = int(_flags.get_flag("ici_bulk_claim_timeout_s") * 1e6)
        rc = lib.brpc_tpu_torch_fab_recv(
            h, uuid, timeout_us, ctypes.byref(out),
            ctypes.byref(olen)) if h else -2
        if rc != 0:
            raise ConnectionError(
                f"fabric bulk frame {uuid:#x} unclaimable (rc {rc})")
        return out, olen.value, h, lib

    def _claim_zero_copy(self, uuid: int, expect_len: int):
        """A claimed bulk frame as a ctypes array over the native buffer,
        its exactly-once release chained through ``._owner``."""
        ptr, n, h, lib = self._bulk_claim(uuid)
        if n != expect_len:
            lib.brpc_tpu_torch_fab_buf_release(h, ptr, n)
            raise ConnectionError(f"bulk frame {uuid:#x}: {n} bytes, "
                                  f"descriptor said {expect_len}")
        ca = (ctypes.c_uint8 * n).from_address(
            ctypes.addressof(ptr.contents))
        ca._owner = _NativeBufOwner(lib.brpc_tpu_torch_fab_buf_release, h,
                                    ptr, n)
        return ca

    def _bulk_claim_bytes(self, uuid: int, expect_len: int) -> bytes:
        ptr, n, h, lib = self._bulk_claim(uuid)
        try:
            if n != expect_len:
                raise ConnectionError(f"bulk frame {uuid:#x}: {n} bytes, "
                                      f"descriptor said {expect_len}")
            with self._bulk_lock:
                self.bulk_bytes_claimed += n
            return ctypes.string_at(ptr, n)
        finally:
            lib.brpc_tpu_torch_fab_buf_release(h, ptr, n)

    def _shm_claim(self, uuid: int):
        """(ptr, len, handle, lib) of one ring frame.  A retired ring is
        asked first, without waiting (descriptors sent around its death
        name bytes published there); then the live ring, with the claim
        timeout."""
        with self._bulk_lock:
            h, dead_h, lib = self._shm, self._shm_dead, self._shmlib
            stripes, dead_stripes = self._shm_stripes, \
                self._shm_dead_stripes
        out, olen = _u8p(), ctypes.c_uint64()
        if dead_h:
            if dead_stripes > 1:
                rc = lib.brpc_tpu_torch_shm_recv2(
                    dead_h, self._shm_stripe_of(uuid, dead_stripes),
                    uuid, 0, ctypes.byref(out), ctypes.byref(olen))
            else:
                rc = lib.brpc_tpu_torch_shm_recv(
                    dead_h, uuid, 0, ctypes.byref(out), ctypes.byref(olen))
            if rc == 0:
                return out, olen.value, dead_h, lib
        timeout_us = int(_flags.get_flag("ici_bulk_claim_timeout_s") * 1e6)
        if not h:
            rc = -2
        elif stripes > 1:
            rc = lib.brpc_tpu_torch_shm_recv2(
                h, self._shm_stripe_of(uuid, stripes), uuid, timeout_us,
                ctypes.byref(out), ctypes.byref(olen))
        else:
            rc = lib.brpc_tpu_torch_shm_recv(
                h, uuid, timeout_us, ctypes.byref(out), ctypes.byref(olen))
        if rc != 0:
            raise ConnectionError(
                f"fabric shm frame {uuid:#x} unclaimable (rc {rc})")
        return out, olen.value, h, lib

    def _shm_claim_zero_copy(self, uuid: int, expect_len: int):
        """A claimed ring frame as a ctypes array over the slot itself; the
        slot retires (ring credit returns) when the last view dies."""
        ptr, n, h, lib = self._shm_claim(uuid)
        if n != expect_len:
            lib.brpc_tpu_torch_shm_release(h, ptr, n)
            raise ConnectionError(f"shm frame {uuid:#x}: {n} bytes, "
                                  f"descriptor said {expect_len}")
        ca = (ctypes.c_uint8 * n).from_address(
            ctypes.addressof(ptr.contents))
        ca._owner = _NativeBufOwner(lib.brpc_tpu_torch_shm_release, h, ptr,
                                    n)
        with self._bulk_lock:
            self.shm_bytes_claimed += n
        return ca

    def _shm_claim_bytes(self, uuid: int, expect_len: int) -> bytes:
        """Kind-6 host bytes: one owned copy off the ring (the parser
        consumes them), the slot retired at once."""
        ptr, n, h, lib = self._shm_claim(uuid)
        try:
            if n != expect_len:
                raise ConnectionError(f"shm frame {uuid:#x}: {n} bytes, "
                                      f"descriptor said {expect_len}")
            with self._bulk_lock:
                self.shm_bytes_claimed += n
            return ctypes.string_at(ptr, n)
        finally:
            lib.brpc_tpu_torch_shm_release(h, ptr, n)

    def _claim_tensor(self, kind: int, uuid: int, length: int):
        """A kind-2/5 payload as a flat uint8 tensor.  Host delivery (the
        default): a CPU tensor over the native buffer, no copy; its owner
        releases the buffer when the last view dies.  Otherwise one owned
        copy (never an alias of the native buffer), then the socket's
        local rank's device; the buffer is released at once."""
        import torch
        ca = (self._claim_zero_copy if kind == 2
              else self._shm_claim_zero_copy)(uuid, length)
        if kind == 2:
            with self._bulk_lock:
                self.bulk_bytes_claimed += length
        host = torch.frombuffer(ca, dtype=torch.uint8) if length \
            else torch.empty(0, dtype=torch.uint8)
        if _flags.get_flag("ici_fabric_host_delivery"):
            return host
        owned = host.clone()
        del host, ca                  # the owner releases the buffer
        return self.mesh.device_put(owned, self.local_dev)

    # ---- read path -------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while not self.failed:
                fr = _recv_frame(self._conn)
                if fr is None:
                    break
                plan = _fi.fabric_active()
                if plan is not None:
                    plan.on_control_recv(self)    # the peer-crash fault
                ftype, body = fr
                if ftype == _F_DATA:
                    self._on_data(body)
                elif ftype == _F_CREDIT:
                    self._on_credits(struct.unpack("<Q", body)[0])
                elif ftype == _F_PULLED:
                    self._on_pulled(struct.unpack("<Q", body)[0])
                elif ftype == _F_PULL_ERR:
                    self._on_pull_err(body)
                elif ftype in _PLANE_FRAMES:
                    which, op = _PLANE_FRAMES[ftype]
                    self._on_plane_frame(which, op, body)
                elif ftype == _F_GOODBYE:
                    self._on_goodbye()
                elif ftype == _F_DPLANE_SEQ:
                    u, s = struct.unpack("<Qq", body)
                    seqr = self._dplane_sequencer()
                    if seqr is not None:
                        seqr.on_assignment(u, s)
                elif ftype in _COLL_FRAMES:
                    from ..channels import collective_fanout as _cf
                    _cf.on_frame(self, ftype, json.loads(body))
                elif ftype == _F_FIN:
                    if len(body) >= 4:
                        # the peer closed with an explicit code (a
                        # lame-duck ELOGOFF): in-flight calls fail with it
                        self._fin_code = struct.unpack("<I", body[:4])[0]
                    break
        except OSError:
            pass
        except Exception as e:
            # a malformed frame must not strand the socket with a dead
            # reader: surface it as a failure
            log.error("fabric read loop died on %s: %s", self.remote_side, e)
        self._on_connection_over()

    def _on_connection_over(self) -> None:
        """EOF rides the ORDERED delivery queue (an earlier device-bearing
        frame may still be pulling); writers and pinned sends release at
        once, since their acks can never arrive."""
        self._conn_dead = True
        self._wake_window()
        self._flush_staged()
        self._close_bulk()
        self._close_shm()
        self._close_dplane()
        self._importer.close()
        _ipc.sweep_segments(self.peer_os_pid)

        def commit_eof():
            with self._inbox_lock:
                self._peer_closed = True
            if self._fin_code == errors.ELOGOFF:
                # a lame-duck stop: the input path fails the socket with
                # it once the queued input is parsed, as in process
                self._eof_error_code = errors.ELOGOFF
            elif self._fin_code:
                self.set_failed(self._fin_code,
                                "peer failed the connection: "
                                f"{errors.berror(self._fin_code)}")
                return
            self.start_input_event()

        self._enqueue_delivery([], commit_eof)

    def _flush_staged(self) -> None:
        with self._staged_lock:
            staged, self._staged = self._staged, {}
        for t in staged.values():
            _dp.plane().fail_transfer(t, "socket closed before PULLED")
            t.remote.release()

    def _on_data(self, body: bytes) -> None:
        (nchunks,) = struct.unpack_from("<I", body, 0)
        off = 4
        parts: List = []
        waits: List = []
        plane = _dp.plane()
        for _ in range(nchunks):
            (kind,) = struct.unpack_from("<B", body, off)
            off += 1
            if kind == 0:
                (blen,) = struct.unpack_from("<I", body, off)
                off += 4
                parts.append(body[off:off + blen])
                off += blen
                continue
            if kind in (3, 6):
                uuid, blen = struct.unpack_from("<QQ", body, off)
                off += 16
                parts.append(self._bulk_claim_bytes(uuid, blen) if kind == 3
                             else self._shm_claim_bytes(uuid, blen))
                continue
            if kind not in (2, 4, 5):
                raise ValueError(f"fabric: payload kind {kind} is not "
                                 "served by this port")
            uuid, dtlen = struct.unpack_from("<QH", body, off)
            off += 10 + dtlen
            (ndim,) = struct.unpack_from("<B", body, off)
            off += 1 + 8 * ndim
            (length,) = struct.unpack_from("<Q", body, off)
            off += 8
            if kind != 4:
                # delivered as the payload's flat bytes, whatever dtype
                # and shape the descriptor names
                arr = self._claim_tensor(kind, uuid, length)
                if arr.device.type != "cpu":
                    waits.append(arr)          # resident before the read
                parts.append(("dev", arr))
                continue
            src_dev, dseq, d_tid, d_psid = struct.unpack_from(
                "<IqQQ", body, off)
            off += 28
            ext = None
            if self._ipc_peer:
                ext, off = _ipc.parse_ext(body, off)
            t = plane.post_recv_remote(uuid, length, src_dev,
                                       self.local_dev, mesh=self.mesh,
                                       trace_id=d_tid, parent_span_id=d_psid)
            t.remote = ext
            seqr = self._dplane_sequencer()
            if ext is None:
                plane.fail_transfer(t, "the peer sent no export to pull")
            elif seqr is None:
                plane.fail_transfer(t, "socket torn down before execution")
            else:
                seqr.submit_remote(t, dseq)
            parts.append(t)
            waits.append(t)

        def commit():
            buf = IOBuf()
            for p in parts:
                if isinstance(p, _dp.DeviceTransfer):
                    if p.out is None or p.state == _dp.FAILED:
                        # the byte stream cannot be repaired: the socket
                        # and its calls fail with the pull's own code
                        self.set_failed(
                            errors.EINTERNAL,
                            f"device-plane transfer {p.uuid:#x} failed: "
                            f"{p.error}")
                        return
                    self.dplane_bytes_recv += p.nbytes
                    buf.append_device_array(p.out)
                elif isinstance(p, tuple):
                    buf.append_device_array(p[1])
                else:
                    buf.append(p)
            with self._inbox_lock:
                self._inbox.append(buf)
            self.start_input_event(inline=True)

        self._enqueue_delivery(waits, commit)

    def _on_pulled(self, uuid: int) -> None:
        """The receiver's copy finished: the send completes and its pin
        (and export) release — the rdma_endpoint.cpp:926 discipline."""
        with self._staged_lock:
            t = self._staged.pop(uuid, None)
        if t is not None:
            _dp.plane().finish_remote(t)
            t.remote.release()

    def _on_pull_err(self, body: bytes) -> None:
        uuid, code = struct.unpack_from("<QI", body, 0)
        text = body[12:].decode(errors="replace")
        self._device_plane_down(text)
        self._unstage(uuid, text)
        self.set_failed(code, f"peer could not pull a device payload: "
                              f"{text}")

    def _do_read(self, portal: IOPortal, max_count: int) -> int:
        with self._inbox_lock:
            avail = len(self._inbox)
            if avail == 0:
                return 0 if self._peer_closed else -1
            n = min(avail, max_count)
            self._inbox.cutn(portal, n)
            # batched credit return: a CREDIT per parser cut would cost a
            # control send per small read
            self._consumed_unacked += n
            flush = 0
            if (self._consumed_unacked >= self.window_bytes // 8
                    or self._peer_closed):
                flush, self._consumed_unacked = self._consumed_unacked, 0
        if flush:
            try:
                self._ctrl_send(_F_CREDIT, struct.pack("<Q", flush))
            except OSError:
                pass
        return n

    # ---- failure ---------------------------------------------------------
    def set_failed(self, error_code: int = errors.EFAILEDSOCKET,
                   reason: str = "") -> bool:
        """A fabric socket's death is not the endpoint's: a client side
        hands the endpoint to the health checker, whose probe (the PING
        frame) revives it once a server answers there again."""
        first = super().set_failed(error_code, reason)
        if first and error_code != errors.ECLOSE:
            self.node.forget_peer(self.peer_pid)
            if not self.is_server_side:
                from ..rpc.health_check import start_health_check
                start_health_check(self.remote_side)
        return first

    def _transport_close(self) -> None:
        try:
            # FIN carries a lame-duck stop's ELOGOFF, so the peer's
            # in-flight calls fail over without a connection-failure
            # backoff, and a refused device payload's EINTERNAL, so the
            # peer's calls fail with the refusal's code
            body = struct.pack("<I", self.failed_error) \
                if self.failed_error in (errors.ELOGOFF, errors.EINTERNAL) \
                else b""
            self._ctrl_send(_F_FIN, body)
        except OSError:
            pass
        try:
            self._conn.shutdown(_pysocket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._conn.close()
        except OSError:
            pass
        self._wake_window()
        self._flush_staged()
        self._close_bulk()
        self._close_shm()
        self._close_dplane()
        self._importer.close()


def pair_plane_stats() -> Dict[int, dict]:
    """Live fabric sockets grouped by peer process: ``{peer_pid: {conns,
    bytes_in, bytes_out, device_in, device_out}}`` (the /ici page)."""
    from ..rpc.socket import list_sockets
    out: Dict[int, dict] = {}
    for s in list_sockets():
        if not isinstance(s, FabricSocket) or s.failed:
            continue
        row = out.setdefault(s.peer_pid, {"conns": 0, "bytes_in": 0,
                                          "bytes_out": 0, "device_in": 0,
                                          "device_out": 0})
        row["conns"] += 1
        row["bytes_in"] += s.stat.in_size
        row["bytes_out"] += s.stat.out_size
        row["device_in"] += s.dplane_bytes_recv
        row["device_out"] += s.dplane_bytes_sent
    return out


def describe() -> Optional[dict]:
    """The fabric's rows of the /ici page: the node, then per live socket
    its planes, sequencer and IPC cache."""
    node = FabricNode.instance()
    if node is None:
        return None
    from ..rpc.socket import list_sockets
    socks = []
    for s in list_sockets():
        if isinstance(s, FabricSocket) and not s.failed:
            socks.append({"remote": str(s.remote_side),
                          "peer_pid": s.peer_pid,
                          "server_side": s.is_server_side,
                          "planes": s.describe_planes(),
                          "shm": s.describe_shm(),
                          "sequencer": s.describe_dplane_sequencer(),
                          "ipc": s.ipc_stats()})
    return {"process_id": node.process_id,
            "num_processes": node.num_processes, "ranks": node.devices,
            "ctrl": node.ctrl_addr, "sockets": socks,
            "pairs": pair_plane_stats()}


def connect_any(ep, local_dev: Optional[int] = None):
    """Route an ici:// connect: a rank this process owns rides the
    in-process IciSocket, any other the fabric — so ``Channel("ici://k")``
    works the same single- or multi-process."""
    from .transport import ici_connect
    node = FabricNode.instance()
    target = ep.device_id
    if node is None or node.owns(target):
        if node is not None and local_dev is None:
            local_dev = next((r for r in node.devices if r != target),
                             target)
        return ici_connect(ep, local_dev)
    if local_dev is None:
        # the client's residence must be a rank this process owns
        local_dev = node.devices[0]
    return node.connect(target, local_dev)
