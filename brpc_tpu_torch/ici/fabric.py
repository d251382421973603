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
    1-7, 12-16 and 21-24 in the JAX layouts (HELLO/HELLO_OK/HELLO_ERR,
    DATA, CREDIT, PULLED, FIN, PING, GOODBYE, DPLANE_SEQ, and the compiled
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
    and its pin release (:mod:`.ipc_pull`).  There is no other byte mover
    and no fallback: a refused export, open or launch fails the transfer,
    the socket and its calls with EINTERNAL and the reason, and latches the
    peer's device plane down for ``DEVICE_RETRY_S``; while it is
    down DEVICE payloads to that peer fail the same way.  A smaller DEVICE
    payload rides inline as host bytes (kind 0), as it does in the JAX
    package when no bulk plane is attached.
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
    ``on_control_recv``, a HELLO ``on_hello``, and a pull at its slot
    ``on_plane_op(sock, "device")``.

Pod membership (:mod:`.pod`) lives on the same store.  Left out, with the
planes they feed: the transfer server (kind 1), the native bulk listener
and the shm ring (kinds 2, 3, 5, 6 and their revival frames 8-11 and
17-20).  The handshake advertises no ``xfer``, ``bulk``, ``bulk_uds`` or
``shm`` key, so a peer never routes there.

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

# control-channel frame types (the JAX layouts, brpc_tpu/ici/fabric.py:
# 219-248)
_F_HELLO = 1       # json: {target_dev, client_dev, pid, wall_us}
_F_HELLO_OK = 2
_F_HELLO_ERR = 3
_F_DATA = 4        # chunk list: host bytes + device descriptors
_F_CREDIT = 5      # u64 consumed bytes
_F_PULLED = 6      # u64 uuid: the receiver's copy finished
_F_FIN = 7         # [u32 close code]
_F_PING = 12       # u32 target_dev
_F_PING_OK = 13
_F_PING_ERR = 14
_F_GOODBYE = 15
_F_DPLANE_SEQ = 16  # u64 uuid, i64 seq
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
        # the handshake publication (the GID/QPN exchange)
        info = {"ctrl": self.ctrl_addr, "devices": self.devices,
                "host": self.host_ip, "os_pid": os.getpid()}
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

    def quiesce(self) -> None:
        """Close the listener, sever every live fabric socket's control
        conn and join its reader, then the accept loop: after this no
        fabric thread runs, so exit-time teardown has nothing to race."""
        self.shutdown()
        from ..rpc.socket import list_sockets
        for s in list(list_sockets()):
            if isinstance(s, FabricSocket):
                s.quiesce_reader()
        t = self._accept_thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(2.0)

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
            target = hello["target_dev"]
            plan = _fi.fabric_active()
            if plan is not None and plan.on_hello():
                _send_frame(conn, _F_HELLO_ERR, b"injected hello refusal")
                conn.close()
                return
            with _listeners_lock:
                listener = _listeners.get(target)
            if listener is None:
                _send_frame(conn, _F_HELLO_ERR,
                            f"no server at ici://{target}".encode())
                conn.close()
                return
            conn.settimeout(None)
            sock = FabricSocket(conn, local_dev=target,
                                remote_dev=hello["client_dev"],
                                peer_pid=hello["pid"], node=self,
                                fresh_info=True)
            sock.is_server_side = True
            # the messenger attaches before any frame can be read
            listener.on_accept(sock)
            ok = {}
            if "wall_us" in hello:
                ok = {"t0": hello["wall_us"],
                      "wall_us": time.time_ns() // 1000}
            _send_frame(conn, _F_HELLO_OK,
                        json.dumps(ok).encode() if ok else b"")
            sock.start_io()
        except Exception as e:
            log.error("fabric handshake failed: %s", e)
            try:
                conn.close()
            except OSError:
                pass

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
        hello = {"target_dev": target_dev, "client_dev": client_dev,
                 "pid": self.process_id,
                 # clock alignment: our wall at HELLO send; the HELLO_OK
                 # echo and the server's wall bound the peer's offset by
                 # this round trip (±RTT/2, clock.py)
                 "wall_us": time.time_ns() // 1000}
        t0_mono = time.monotonic_ns()
        try:
            _send_frame(conn, _F_HELLO, json.dumps(hello).encode())
            fr = _recv_frame(conn)
        except OSError:
            conn.close()
            self.forget_peer(owner)
            raise
        if fr is None or fr[0] != _F_HELLO_OK:
            msg = fr[1].decode() if fr else "connection closed"
            conn.close()
            raise ConnectionRefusedError(f"fabric: {msg}")
        self._record_clock(owner, fr[1], t0_mono)
        conn.settimeout(None)
        sock = FabricSocket(conn, local_dev=client_dev,
                            remote_dev=target_dev, peer_pid=owner, node=self)
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
        """Per-plane health for the /ici page (the port has one plane)."""
        return {"device": self._plane_device.snapshot()}

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
        """Serialize a frame: host refs inline (kind 0), DEVICE refs the
        route table sends to the device plane as kind-4 descriptors (their
        bytes are pulled by the receiver); a DEVICE ref below the plane's
        threshold rides inline as host bytes."""
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
            out.append(struct.pack("<BI", 0, len(blob)))
            out.append(blob)
            _route.record(self, _route.INLINE, len(blob))

        for i in range(frame.backing_block_num()):
            r = frame.backing_block(i)
            if r.block.kind == DEVICE and _route.candidates(
                    self, _route.DEVICE, r.length) == [_route.DEVICE]:
                arr = r.block.data
                if r.offset or r.length != arr.shape[0]:
                    arr = arr[r.offset:r.offset + r.length]
                desc = self._post_device(arr, r.block)
                flush_host()
                out.append(desc)
                nchunks += 1
                self.dplane_bytes_sent += r.length
                _route.record(self, _route.DEVICE, r.length)
                continue
            # host bytes; a DEVICE ref below the threshold crosses as its
            # host copy (Block.host_view)
            pending_host.append(bytes(r.block.host_view(r.offset, r.length)))
        flush_host()
        out[0] = struct.pack("<I", nchunks)
        return b"".join(out)

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
            if kind != 4:
                raise ValueError(f"fabric: payload kind {kind} is not "
                                 "served by this port")
            uuid, dtlen = struct.unpack_from("<QH", body, off)
            off += 10 + dtlen
            (ndim,) = struct.unpack_from("<B", body, off)
            off += 1 + 8 * ndim
            (length,) = struct.unpack_from("<Q", body, off)
            off += 8
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
