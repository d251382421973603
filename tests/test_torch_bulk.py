"""The port's bulk conn and the fabric's same-host tiers held against the
JAX package.

  * bulk-conn units on both libraries (``csrc/fabric_native.cpp`` and
    ``native/fabric.cpp``): the keyed handshake over the abstract unix
    socket and TCP, claims in either order, gather sends, the chaos modes,
    a refused handshake, the per-pair registry;
  * parity on the CPU, the same inputs through both packages:
    - the DATA frame's descriptors of kinds 2, 3, 5 and 6, with a failed
      ring send falling to the bulk conn in the same frame and an
      oversize one skipping the ring without degrading it;
    - the plane frames 8-11 and 17-20;
    - stream frames 5-7, and the batch bodies;
    - ``route.candidates`` over class x size x plane health x adverts
      (the DEVICE-eligible case is the port's recorded difference);
    - the threaded prober's transitions and counters;
    - ``chaos_plane``'s decisions;
  * two processes (``tests/torch_procs.py``), ``tests/test_chaos_fabric.py``'s
    bulk and shm legs (``:750``, ``:856``, ``:937``, ``:1010``,
    ``:1675``) and, as the port's difference, ``:1265``: a refused device
    post fails EINTERNAL and nothing crosses on the bulk conn;
  * ``chip_smoke.phase_tiers`` (phase 20) rehearsed on the CPU at a small
    size, every check of the card run held.
"""
from __future__ import annotations

import ctypes
import json
import os
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil.iobuf import IOBuf as JBuf
from brpc_tpu.ici import device_plane as jdp
from brpc_tpu.ici import fabric as jfab
from brpc_tpu.ici import plane_health as jph
from brpc_tpu.ici import route as jroute
from brpc_tpu.rpc import errors as jerrors
from brpc_tpu.rpc import fault_injection as jfi
from brpc_tpu.rpc import stream as jstream
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil import native as tnative
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf
from brpc_tpu_torch.ici import fabric as tfab
from brpc_tpu_torch.ici import ipc_pull as tipc
from brpc_tpu_torch.ici import plane_health as tph
from brpc_tpu_torch.ici import route as troute
from brpc_tpu_torch.ici.mesh import IciMesh as TMesh
from brpc_tpu_torch.rpc import errors as terrors
from brpc_tpu_torch.rpc import fault_injection as tfi
from brpc_tpu_torch.rpc import stream as tstream

u8p = ctypes.POINTER(ctypes.c_uint8)
UUID = (1 << 40) | 0x77


class _Fab:
    """One library's bulk-conn API under short names (``fab_send`` ...)."""

    def __init__(self, name):
        if name == "jax":
            from brpc_tpu.butil import native
            self.lib, self.prefix = native.load(), "brpc_tpu_"
        else:
            self.lib, self.prefix = tnative.load_fabric(), "brpc_tpu_torch_"
        assert self.lib is not None

    def __getattr__(self, short):
        return getattr(self.lib, self.prefix + short)


_LIBS = {}


def _fab(name) -> _Fab:
    if name not in _LIBS:
        _LIBS[name] = _Fab(name)
    return _LIBS[name]


BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def _pair(F, uds=True, key=b"k"):
    port = ctypes.c_int()
    name = ctypes.create_string_buffer(108)
    lh = F.fab_listen(b"127.0.0.1", ctypes.byref(port), name, 108)
    assert lh and port.value and name.value
    if uds:
        c = F.fab_connect_uds(name.value, key)
    else:
        c = F.fab_connect(b"127.0.0.1", port.value, key)
    assert c
    s = F.fab_accept(lh, key, 5_000_000)
    assert s
    return lh, c, s


def _fsend(F, h, uuid, payload):
    buf = (ctypes.c_uint8 * max(len(payload), 1)).from_buffer_copy(
        payload or b"\0")
    return F.fab_send(h, uuid, buf, len(payload))


def _frecv(F, h, uuid, timeout_us=5_000_000):
    out, olen = u8p(), ctypes.c_uint64()
    rc = F.fab_recv(h, uuid, timeout_us, ctypes.byref(out),
                    ctypes.byref(olen))
    data = ctypes.string_at(out, olen.value) if rc == 0 else None
    if rc == 0:
        F.fab_buf_release(h, out, olen.value)
    return rc, data


def _close(F, lh, *hs):
    for h in hs:
        F.fab_conn_close(h)
    F.fab_listener_close(lh)


# ---------------------------------------------------------------------------
# Bulk-conn units, both libraries.
# ---------------------------------------------------------------------------

@BOTH
@pytest.mark.parametrize("uds", [True, False], ids=["uds", "tcp"])
def test_claims_in_either_order_and_gather_send(pkg, uds):
    F = _fab(pkg)
    lh, c, s = _pair(F, uds)
    a, b = os.urandom(300_000), os.urandom(5)
    assert _fsend(F, c, 1, a) == 0 and _fsend(F, c, 2, b) == 0
    assert _frecv(F, s, 2) == (0, b)          # claim by uuid, any order
    assert _frecv(F, s, 1) == (0, a)
    # a claim posted before its frame waits for it
    got = {}
    t = threading.Thread(target=lambda: got.update(r=_frecv(F, c, 9)))
    t.start()
    time.sleep(0.05)
    assert _fsend(F, s, 9, b"late") == 0
    t.join(5)
    assert got["r"] == (0, b"late")
    # gather: three segments, one frame
    raw = (ctypes.c_uint8 * len(a)).from_buffer_copy(a)
    base = ctypes.addressof(raw)
    ptrs = (ctypes.c_void_p * 3)(base, base + 10, base + 1000)
    lens = (ctypes.c_uint64 * 3)(10, 990, len(a) - 1000)
    assert F.fab_sendv(c, 3, ptrs, lens, 3) == 0
    assert _frecv(F, s, 3) == (0, a)
    assert F.fab_bytes(c, 1) == len(a) * 2 + len(b)
    assert F.fab_alive(c) == 1 and F.fab_alive(s) == 1
    assert _frecv(F, s, 77, timeout_us=50_000)[0] == -1   # timeout
    _close(F, lh, c, s)


@BOTH
def test_chaos_modes_and_refused_handshake(pkg):
    F = _fab(pkg)
    lh, c, s = _pair(F)
    assert F.fab_chaos(s, 2, 1) == 0                  # drop the next frame
    assert _fsend(F, c, 1, b"vanishes") == 0
    assert _frecv(F, s, 1, 200_000)[0] == -1
    assert _fsend(F, c, 2, b"arrives") == 0
    assert _frecv(F, s, 2) == (0, b"arrives")
    assert F.fab_chaos(s, 3, 150) == 0                # delay the parking
    t0 = time.monotonic()
    assert _fsend(F, c, 3, b"slow") == 0
    assert _frecv(F, s, 3) == (0, b"slow")
    assert time.monotonic() - t0 >= 0.14
    assert F.fab_chaos(s, 0, 0) == 0
    # a watermark inside the next frame: truncated mid-writev, both dead
    assert F.fab_chaos(c, 1, F.fab_bytes(c, 1) + 100) == 0
    assert _fsend(F, c, 4, b"x" * 1000) == -1
    assert F.fab_alive(c) == 0
    deadline = time.monotonic() + 5
    while F.fab_alive(s) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert F.fab_alive(s) == 0 and _frecv(F, s, 4)[0] == -2
    _close(F, lh, c, s)
    # the listener refuses the next key handshake: its claim times out,
    # and the one after binds
    port = ctypes.c_int()
    name = ctypes.create_string_buffer(108)
    lh = F.fab_listen(b"127.0.0.1", ctypes.byref(port), name, 108)
    assert F.fab_chaos_listener(lh, 1) == 0
    c = F.fab_connect_uds(name.value, b"refused")
    assert F.fab_accept(lh, b"refused", 300_000) == 0
    c2 = F.fab_connect_uds(name.value, b"second")
    s2 = F.fab_accept(lh, b"second", 5_000_000)
    assert s2
    _close(F, lh, c, c2, s2)


@BOTH
def test_pair_registry(pkg):
    F = _fab(pkg)
    lh, c, s = _pair(F)
    F.fab_set_peer(c, 4242)
    F.fab_set_peer(s, 4243)
    assert _fsend(F, c, 1, b"abc") == 0
    assert _frecv(F, s, 1) == (0, b"abc")
    conns, bi, bo = (ctypes.c_uint64(), ctypes.c_uint64(),
                     ctypes.c_uint64())
    F.fab_pair_stats(4242, ctypes.byref(conns), ctypes.byref(bi),
                     ctypes.byref(bo))
    assert (conns.value, bi.value, bo.value) == (1, 0, 3)
    peers = (ctypes.c_int32 * 64)()
    n = F.fab_peer_list(peers, 64)
    assert {4242, 4243} <= set(peers[:n])
    _close(F, lh, c, s)


# ---------------------------------------------------------------------------
# Parity of the wire on the CPU.
# ---------------------------------------------------------------------------

class _JNode:
    _xfer_server = None
    process_id = 0

    def peer_info(self, pid, timeout_ms=60000):
        return {"dplane3": 3}

    def shm_peer_ok(self, pid):
        return False

    def next_uuid(self):
        return UUID


class _TNode:
    def __init__(self):
        self.mesh = TMesh(ranks=8, device="cpu")
        self._health = tph.register_plane("device", threading.Lock(),
                                          retry_s=lambda: 2.0)

    def peer_info(self, pid, timeout_ms=30000, fresh=False):
        return {"dplane3": 3, tipc.HANDSHAKE_KEY: tipc.HANDSHAKE_VERSION,
                "os_pid": 0}

    def device_health(self, pid):
        return self._health

    def shm_peer_ok(self, pid):
        return False

    def next_uuid(self):
        return UUID

    def forget_peer(self, pid):
        pass


class _FakeLib:
    """Every native entry: records the call, returns 1."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        short = name.replace("brpc_tpu_torch_", "").replace("brpc_tpu_", "")

        def fn(*args):
            self.calls.append((short,) + tuple(
                a for a in args if isinstance(a, (int, bytes))))
            return 1
        return fn


def _sock(name, conn, node=None):
    fab = jfab if name == "jax" else tfab
    node = node or (_JNode() if name == "jax" else _TNode())
    s = fab.FabricSocket(conn, local_dev=0, remote_dev=5, peer_pid=1,
                         node=node)
    s.is_server_side = True
    return s


def _read_frames(conn, timeout=0.5):
    conn.settimeout(timeout)
    data = b""
    while True:
        try:
            chunk = conn.recv(1 << 16)
        except socket.timeout:
            break
        if not chunk:
            break
        data += chunk
    frames, off = [], 0
    while off + 5 <= len(data):
        ftype, n = struct.unpack_from("<BI", data, off)
        frames.append((ftype, data[off + 5:off + 5 + n]))
        off += 5 + n
    return frames


def _as_bytes(data):
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    if isinstance(data, torch.Tensor):
        return bytes(data.numpy())
    return np.asarray(data).tobytes()


_HOST_HEAD = b"0123456789"
_HOST_BIG = bytes(i % 253 for i in range(70_000))
_DEV = (np.arange(4096) % 249).astype(np.uint8)


def _encode(name, usable, shm_fault=None):
    """One frame (10 host bytes, a 4 KiB DEVICE payload the device plane
    does not carry, 70,000 host bytes) encoded with the planes in
    ``usable``; ``shm_fault`` makes every ring send raise it."""
    a, _b = socket.socketpair()
    s = _sock(name, a)
    sends, downs = [], []
    s.plane_usable = lambda plane, n=0: plane in usable
    with s._bulk_lock:
        s._shm_stripes = 4

    def shm_send(uuid, data):
        if shm_fault is not None:
            raise shm_fault()
        sends.append(("shm", uuid, _as_bytes(data)))

    s._shm_send = shm_send
    s._bulk_send = lambda uuid, data: sends.append(
        ("bulk", uuid, _as_bytes(data)))
    s._shm_plane_down = lambda reason, notify=True: downs.append(reason)
    if name == "jax":
        import jax
        s._dplane_usable = lambda n: False
        frame = JBuf(_HOST_HEAD)
        frame.append_device_array(jax.device_put(_DEV, jax.devices()[1]))
        frame.append(_HOST_BIG)
    else:
        s.dplane_eligible = lambda n: False
        frame = TBuf(_HOST_HEAD)
        frame.append_device_array(s.mesh.device_put(
            torch.from_numpy(_DEV.copy()), 1))
        frame.append(_HOST_BIG)
    body = s._encode_data(frame)
    s.set_failed(terrors.ECLOSE, "done")
    return body, sends, downs


@pytest.mark.parametrize("case", ["shm", "bulk", "shm_dies", "oversize",
                                  "inline"])
def test_data_frame_descriptors_kinds_2_3_5_6_equal_jax(case):
    usable = {"shm": {"shm", "bulk"}, "bulk": {"bulk"},
              "shm_dies": {"shm", "bulk"}, "oversize": {"shm", "bulk"},
              "inline": set()}[case]
    fault = {"shm_dies": ConnectionError}.get(case)
    jfault = tfault = fault
    if case == "oversize":
        jfault, tfault = jfab._ShmOversize, tfab._ShmOversize
    jres = _encode("jax", usable, jfault)
    tres = _encode("port", usable, tfault)
    assert tres == jres
    body, sends, downs = tres
    kinds = []
    off = 4
    for _ in range(struct.unpack_from("<I", body)[0]):
        kind = body[off]
        kinds.append(kind)
        if kind == 0:
            off += 5 + struct.unpack_from("<I", body, off + 1)[0]
        elif kind in (3, 6):
            off += 17
        else:
            off += 1 + 10 + 5 + 1 + 8 + 8
    want = {"shm": [0, 5, 6], "bulk": [0, 2, 3], "shm_dies": [0, 2, 3],
            "oversize": [0, 2, 3], "inline": [0]}[case]
    assert kinds == want
    assert len(downs) == (2 if case == "shm_dies" else 0)
    if case == "shm":
        # unary frames round-robin the stripes from stripe 0
        assert sends == [("shm", UUID, _DEV.tobytes()),
                         ("shm", (1 << 56) | UUID, _HOST_BIG)]


def _decode(name, body, parts):
    """Both packages' receivers on one DATA body whose kind-2/3/5/6
    payloads are ``parts`` (uuid -> bytes): the delivered blocks' kinds,
    bytes and where a DEVICE block lives."""
    a, _b = socket.socketpair()
    s = _sock(name, a)
    s.start_input_event = lambda *args, **kw: None

    def zero_copy(uuid, n):
        data = parts[uuid]
        assert len(data) == n
        return (ctypes.c_uint8 * n).from_buffer_copy(data)

    s._claim_zero_copy = s._shm_claim_zero_copy = zero_copy
    s._bulk_claim_bytes = s._shm_claim_bytes = \
        lambda uuid, n: parts[uuid][:n]
    s._on_data(body)
    with s._inbox_lock:
        buf = s._inbox
        out = []
        for i in range(buf.backing_block_num()):
            r = buf.backing_block(i)
            out.append((r.block.kind,
                        bytes(r.block.host_view(r.offset, r.length)),
                        type(r.block.data).__name__ if r.block.kind == 2
                        else None))
    s.set_failed(terrors.ECLOSE, "done")
    return out


def test_receiver_blocks_of_kinds_2_3_5_6_equal_jax():
    """One DATA body (inline bytes, then kinds 3, 2, 6 and 5) decodes to
    the same blocks in both receivers: kinds 3/6 host bytes, kinds 2/5 a
    DEVICE block over the claimed bytes (a host-resident numpy array in
    the JAX package, a CPU tensor in the port), equal bytes."""
    blob3, blob6 = os.urandom(70_000), os.urandom(80_000)
    dev2, dev5 = os.urandom(4096), os.urandom(1000)
    parts = {11: blob3, 12: dev2, 13: blob6, 14: dev5}
    body = (struct.pack("<I", 5) + struct.pack("<BI", 0, 5) + b"hello"
            + struct.pack("<BQQ", 3, 11, len(blob3))
            + tfab.encode_array_descriptor(2, 12, len(dev2))
            + struct.pack("<BQQ", 6, 13, len(blob6))
            + tfab.encode_array_descriptor(5, 14, len(dev5)))
    jout = _decode("jax", body, parts)
    tout = _decode("port", body, parts)
    assert [b[:2] for b in tout] == [b[:2] for b in jout]
    assert b"".join(b[1] for b in tout) == \
        b"hello" + blob3 + dev2 + blob6 + dev5
    assert [b[2] for b in jout if b[0] == 2] == ["ndarray", "ndarray"]
    assert [b[2] for b in tout if b[0] == 2] == ["Tensor", "Tensor"]


def _plane_frames(name):
    fab, fi = (jfab, jfi) if name == "jax" else (tfab, tfi)
    a, b = socket.socketpair()
    node = _JNode() if name == "jax" else _TNode()
    lib = _FakeLib()
    node._bulk_listener = 1
    node._bulk_lib = lib
    node._shm_ok = True
    node._shm_lib = lib
    node._reap_parked_bulk = lambda key: None
    node.dial_bulk = lambda pid, info=None: (5, "0:abc", lib, True)
    node.create_shm_segment = lambda: (6, "seg.0.1", lib)
    node.drop_shm_segment = lambda h, n: None
    s = _sock(name, a, node)
    s._plane_notify_down("bulk")
    s._plane_notify_down("shm")
    for which, attempt in (("bulk", s._bulk_revive_attempt),
                           ("shm", s._shm_revive_attempt)):
        res = {}
        t = threading.Thread(target=lambda: res.update(ok=attempt()))
        t.start()
        time.sleep(0.1)
        s._on_plane_frame(which, 2, b"")            # the server's OK
        t.join(5)
        assert res["ok"] is True
    s._on_plane_frame("bulk", 1, json.dumps({"bulk_key": "1:9"}).encode())
    s._on_plane_frame("shm", 1, json.dumps({"shm_seg": "seg.1.2"}).encode())
    with fi.inject_fabric(fi.FabricFaultPlan(refuse_bulk_handshakes=1,
                                             refuse_shm_handshakes=1)) as p:
        s._on_plane_frame("bulk", 1, json.dumps({"bulk_key": "1:a"}).encode())
        s._on_plane_frame("shm", 1, json.dumps({"shm_seg": "s"}).encode())
        injected = dict(p.injected)
    frames = _read_frames(b)
    epochs = (s.bulk_epoch(), s.shm_epoch())
    s._on_plane_frame("shm", 0, b"")                 # the peer saw it die
    down = s.describe_planes()["shm"]["state"]
    s.set_failed(terrors.ECLOSE, "done")
    b.close()
    return frames, epochs, down, injected


def test_plane_frames_8_to_11_and_17_to_20_equal_jax():
    for a in ("_F_BULK_DOWN", "_F_BULK_REESTABLISH", "_F_BULK_OK",
              "_F_BULK_ERR", "_F_SHM_DOWN", "_F_SHM_REESTABLISH",
              "_F_SHM_OK", "_F_SHM_ERR"):
        assert getattr(tfab, a) == getattr(jfab, a), a
    assert tfab._PLANE_FRAMES == jfab._PLANE_FRAMES
    jres = _plane_frames("jax")
    tres = _plane_frames("port")
    assert tres[:3] == jres[:3]
    assert tres[3] == {k: jres[3][k] for k in tres[3]}
    frames = tres[0]
    assert [f[0] for f in frames] == [8, 17, 9, 18, 10, 19, 11, 20]
    assert json.loads(frames[2][1]) == {"bulk_key": "0:abc"}
    assert json.loads(frames[3][1]) == {"shm_seg": "seg.0.1"}
    assert tres[1] == (2, 2) and tres[2] == "down"


class _StreamSock:
    """What a Stream asks of its socket, recording every write."""

    def __init__(self, routes, fail_shm=0):
        self.routes = list(routes)
        self.fail_shm = fail_shm
        self.writes, self.fast = [], []
        self.on_failed_callbacks = []
        self.failed = False
        self.n = 0

    def stream_fast_begin(self, nbytes, affinity=None):
        self.n += 1
        return UUID + self.n, self.routes.pop(0)

    def stream_fast_send(self, route, uuid, frame):
        if route == "shm" and self.fail_shm:
            self.fail_shm -= 1
            raise ConnectionError("ring died")
        self.fast.append((route, uuid, frame.to_bytes()))

    def stream_fast_abort(self, route):
        self.fast.append(("abort", route))

    def write(self, buf):
        self.writes.append(buf.to_bytes())
        return 0


def _stream_wire(name, routes, fail_shm=0):
    st_mod, flags, Buf = ((jstream, jflags, JBuf) if name == "jax"
                          else (tstream, tflags, TBuf))
    saved = {k: flags.get_flag(k) for k in ("ici_stream_desc_batch",
                                            "ici_stream_desc_flush_us")}
    flags.set_flag("ici_stream_desc_batch", 2)
    flags.set_flag("ici_stream_desc_flush_us", 30_000_000)
    try:
        sock = _StreamSock(routes, fail_shm)
        st = st_mod.Stream(st_mod.StreamOptions(), is_client=True)
        st.sid, st.remote_sid, st.socket, st.connected = 3, 9, sock, True
        big = bytes(range(256)) * 320                    # 80 KiB
        for i in range(4):
            st._send_frame(st_mod.FRAME_DATA, Buf(big[i:] + big[:i]))
        st._send_frame(st_mod.FRAME_DATA, Buf(b"small"))
        st._send_frame(st_mod.FRAME_FEEDBACK, None, consumed_bytes=77)
        st._send_frame(st_mod.FRAME_CLOSE, None)
        return sock.writes, sock.fast
    finally:
        for k, v in saved.items():
            flags.set_flag(k, v)


@pytest.mark.parametrize("routes,fail_shm", [
    (["shm", "shm", "shm", "bulk"], 0),
    (["shm", "bulk", "shm", "shm", "shm"], 1),
], ids=["batch", "ring_dies"])
def test_stream_frames_5_to_7_and_batch_bodies_equal_jax(routes, fail_shm):
    for a in ("FRAME_DATA_BULK", "FRAME_DATA_SHM", "FRAME_DATA_SHM_BATCH"):
        assert getattr(tstream, a) == getattr(jstream, a)
    jw = _stream_wire("jax", routes, fail_shm)
    tw = _stream_wire("port", routes, fail_shm)
    assert tw == jw
    writes, fast = tw
    assert len(writes) >= 5
    if fail_shm == 0:
        # 2 ring frames in one batch (7), a lone one (6), then the bulk
        # descriptor (5) before its bytes, then small, feedback, close
        assert [f[0] for f in fast] == ["shm", "shm", "shm", "bulk"]
        batch = writes[0]
        assert struct.pack("<QQ", UUID + 1, 80 * 1024) in batch
        assert struct.pack("<QQ", UUID + 2, 80 * 1024) in batch
    else:
        # the failed publish fell to the bulk conn for the same frame
        assert fast[0] == ("bulk", UUID + 2, fast[0][2])


def _discard(st_mod, meta_mod, Buf, frame_type, body):
    """A fast-plane frame for a stream id nobody holds: what the receiver
    claims (and so releases)."""
    claims = []

    class Sock:
        def stream_bulk_claim(self, uuid, n):
            claims.append(("bulk", uuid, n))

        def stream_shm_claim(self, uuid, n):
            claims.append(("shm", uuid, n))

    meta = meta_mod.RpcMeta()
    meta.stream_settings.stream_id = 987654321
    meta.stream_settings.frame_type = frame_type
    st_mod.on_stream_frame(meta, Buf(body), Sock())
    return claims


@pytest.mark.parametrize("frame_type", [5, 6, 7])
def test_descriptors_for_a_closed_stream_are_claimed_and_dropped(frame_type):
    """``_discard_bulk_frame``: the bytes a descriptor names for a closed
    stream are claimed (the buffer or ring slot returns), as in JAX."""
    from brpc_tpu.proto import rpc_meta_pb2 as jmeta
    from brpc_tpu_torch.proto import rpc_meta_pb2 as tmeta
    n = 3 if frame_type == 7 else 1
    body = b"".join(struct.pack("<QQ", UUID + i, 1000 + i) for i in range(n))
    jc = _discard(jstream, jmeta, JBuf, frame_type, body)
    tc = _discard(tstream, tmeta, TBuf, frame_type, body)
    assert tc == jc
    assert [c[1] for c in tc] == [UUID + i for i in range(n)]


class _RouteSock:
    def __init__(self, shm, bulk, eligible, xfer=False):
        self.health = {"shm": shm, "bulk": bulk, "xfer": xfer}
        self.eligible = eligible

    def plane_usable(self, plane, nbytes=0):
        h = self.health.get(plane)
        if plane == "shm" and h == "small":
            return nbytes + 48 <= 1 << 20
        return bool(h)

    def dplane_eligible(self, nbytes):
        return self.eligible


def test_route_candidates_grid_equal_jax():
    """Every class x size x ring/bulk health x adverts gives the JAX list
    (the JAX table's xfer row is never usable here); a DEVICE payload the
    device plane must carry is the port's difference: ``[device]``
    alone, where the JAX fabric consults its device plane before the
    table and falls to it on a refusal."""
    n = 0
    for cls in (troute.HOST, troute.DEVICE, troute.STREAM):
        for size in (0, 100, 65535, 65536, 1 << 20, 40 << 20):
            for shm in (True, False, "small"):
                for bulk in (True, False):
                    sock = _RouteSock(shm, bulk, eligible=False)
                    assert troute.candidates(sock, cls, size) == \
                        jroute.candidates(sock, cls, size), (cls, size)
                    n += 1
                    sock = _RouteSock(shm, bulk, eligible=True)
                    got = troute.candidates(sock, cls, size)
                    if cls == troute.DEVICE:
                        assert got == [troute.DEVICE]
                    else:
                        assert got == jroute.candidates(sock, cls, size)
    assert n == 108


def _prober_run(ph, route_mod, name):
    lock = threading.Lock()
    state = {"attached": False, "tries": 0, "dead": False}
    log = []
    rec = None

    def prober():
        state["tries"] += 1
        log.append(("try", state["tries"], rec.snapshot()["state"]))
        if state["tries"] < 3:
            return False
        state["attached"] = True
        rec.revived()
        return True

    rec = ph.register_plane(
        name, lock, probe=lambda n: n < 1000, prober=prober,
        attached=lambda: state["attached"], dead=lambda: state["dead"],
        gate=lambda: True, seed=7, backoff_base=0.2, backoff_cap=0.4)
    before = dict(route_mod.plane_stats())
    log.append(("up", rec.usable(10), rec.usable(5000)))
    state["attached"] = False
    log.append(("down", rec.mark_down("killed"), rec.mark_down("again")))
    rec.kick()
    rec.kick()                                 # one loop only
    log.append(("while_down", rec.usable(10)))
    deadline = time.monotonic() + 5
    while (not state["attached"] or rec.snapshot()["state"] != "up") \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    deadline = time.monotonic() + 5
    while rec.running and time.monotonic() < deadline:
        time.sleep(0.005)               # the loop exits on attach
    log.append(("revived", rec.snapshot()))
    log.append(("ramp", rec.usable(10), rec.snapshot()["half_open"]))
    # a dead socket ends the loop without a probe
    state["attached"] = False
    state["dead"] = True
    rec.mark_down("killed again")
    rec.kick()
    deadline = time.monotonic() + 5
    while rec.running and time.monotonic() < deadline:
        time.sleep(0.005)               # the loop sees the dead socket
    log.append(("dead", rec.snapshot(), state["tries"]))
    after = route_mod.plane_stats()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if k.startswith(name) and v != before.get(k, 0)}
    return log, delta, (rec.wanted, rec.running)


def test_threaded_prober_transitions_and_counters_equal_jax():
    jres = _prober_run(jph, jroute, "tpb_prober_j")
    tres = _prober_run(tph, troute, "tpb_prober_t")
    jlog, jdelta, jflagsx = jres
    tlog, tdelta, tflagsx = tres
    assert tlog == jlog
    assert {k.replace("tpb_prober_t", ""): v for k, v in tdelta.items()} \
        == {k.replace("tpb_prober_j", ""): v for k, v in jdelta.items()}
    assert tflagsx == jflagsx == (True, False)
    assert [e[2] for e in tlog if e[0] == "try"] == ["reestablishing"] * 3
    assert tdelta == {"tpb_prober_t_down": 2, "tpb_prober_t_reprobe": 3,
                      "tpb_prober_t_revived": 1, "tpb_prober_t_ramp": 1}


class _ChaosSock:
    def __init__(self, bulk, shm):
        self._bulk_lock = threading.Lock()
        self._bulk, self._shm = bulk, shm
        self._blib = self._shmlib = _FakeLib()


def test_chaos_plane_decisions_equal_jax():
    grid = [(p, m, v) for p in ("bulk", "shm", "device", "xfer")
            for m in ("kill", "blackhole", "slow", "bogus")
            for v in (0, 40)]
    out = {}
    for name, fi in (("jax", jfi), ("port", tfi)):
        rows = []
        for plane, mode, value in grid:
            for bulk, shm in ((3, 4), (0, 0)):
                s = _ChaosSock(bulk, shm)
                rows.append((fi.chaos_plane(s, plane, mode, value),
                             s._blib.calls))
        out[name] = rows
    assert out["port"] == out["jax"]
    for a in ("CHAOS_CLEAR", "CHAOS_SEVER_AFTER_OUT_BYTES",
              "CHAOS_DROP_FRAMES", "CHAOS_DELAY_PARK_MS", "CHAOS_SEVER_NOW",
              "KILL", "BLACKHOLE", "SLOW"):
        assert getattr(tfi, a) == getattr(jfi, a)


def test_flags_have_the_jax_defaults():
    for f in ("ici_fabric_bulk", "ici_fabric_bulk_host_min",
              "ici_fabric_host_delivery", "ici_bulk_claim_timeout_s",
              "ici_fabric_shm", "ici_shm_ring_bytes",
              "ici_shm_send_timeout_s", "ici_shm_stripes",
              "ici_stream_bulk_threshold", "ici_stream_desc_batch",
              "ici_stream_desc_flush_us"):
        assert tflags.flag_object(f).default == \
            jflags.flag_object(f).default, f


# ---------------------------------------------------------------------------
# Two processes: the chaos legs.
# ---------------------------------------------------------------------------

_COMMON = r"""
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.ici import device_plane as dp
made = []                                  # the segments this process made
_create = node.create_shm_segment

def _recording_create():
    h, name, lib = _create()
    if name:
        made.append(name)
    return h, name, lib

node.create_shm_segment = _recording_create
from brpc_tpu_torch.rpc import fault_injection as fi
flags.set_flag("ici_device_plane_threshold", 1 << 30)
CHUNK = 256 * 1024

def mk(seq, n=CHUNK):
    return bytes([seq % 251]) * n

class StreamSink(rpc.StreamInputHandler):
    def __init__(self):
        self.next, self.bad = 0, 0
        self.closed = threading.Event()
    def on_received_messages(self, sid, msgs):
        for m in msgs:
            if m.to_bytes() != mk(self.next, len(m)):
                self.bad += 1
            self.next += 1
    def on_closed(self, sid):
        self.closed.set()

sinks = []

class Svc(rpc.Service):
    SERVICE_NAME = "Svc"
    @rpc.method(EchoRequest, EchoResponse)
    def Start(self, cntl, request, response, done):
        h = StreamSink()
        sinks.append(h)
        rpc.stream_accept(cntl, rpc.StreamOptions(handler=h,
                                                  max_buf_size=8 << 20))
        done()
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        cntl.response_attachment.append(cntl.request_attachment)
        done()

servers = []
if pid == 0:
    for r in (0, 1):
        srv = rpc.Server(rpc.ServerOptions(native_ici=False))
        srv.add_service(Svc())
        assert srv.start("ici://%d" % r) == 0
        servers.append(srv)
barrier("up", 30)

def channel(rank):
    ch = rpc.Channel()
    ch.init("ici://%d" % rank, options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    return ch

def client_sock(rank):
    return [s for s in fabric_socks() if s.remote_dev == rank
            and not s.failed and not s.is_server_side][0]

def open_stream(ch):
    cntl = rpc.Controller()
    st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=8 << 20))
    ch.call_method("Svc.Start", cntl, EchoRequest(message="s"),
                   EchoResponse)
    assert not cntl.failed(), cntl.error_text
    assert st.wait_connected(10)
    return st

def echo(ch, data, device=False):
    cntl = rpc.Controller()
    if device:
        cntl.request_attachment.append_device_array(
            mesh.own(torch.frombuffer(bytearray(data), dtype=torch.uint8), 2))
    else:
        cntl.request_attachment.append(data)
    ch.call_method("Svc.Echo", cntl, EchoRequest(message="e"), EchoResponse)
    if cntl.failed():
        return (cntl.error_code_, cntl.error_text)
    return None if cntl.response_attachment.to_bytes() == data else "corrupt"

def wait_for(fn, t=20):
    end = time.time() + t
    while not fn() and time.time() < end:
        time.sleep(0.02)
    return fn()

out = {}
"""

_FINISH = r"""
barrier("done", 60)
if pid == 0:
    wait_for(lambda: all(h.closed.is_set() for h in sinks), 10)
    out["sinks"] = [(h.next, h.bad, h.closed.is_set()) for h in sinks]
    out["server_failed"] = [s.failed for s in fabric_socks()
                            if s.is_server_side]
for srv in servers:
    srv.stop()
out["foreign"] = foreign()
out["made"] = made
result(out)
finish()
"""

# test_chaos_fabric.py:750 and :856 (the socket bulk conn; the ring off)
_BULK_STREAMS = r"""
flags.set_flag("ici_fabric_shm", False)
""" + _COMMON + r"""
if pid == 1:
    # (a) the bulk conn dies mid-stream: frames ride inline, it revives
    ch = channel(0)
    st = open_stream(ch)
    s = client_sock(0)
    rcs = [st.write(IOBuf(mk(seq)), timeout=30) for seq in range(4)]
    healthy = s.bulk_bytes_sent
    h, lib = s._bulk, s._blib
    lib.brpc_tpu_torch_fab_chaos(h, fi.CHAOS_SEVER_NOW, 0)
    # the sever lands when the conn's reader sees it: the next frame
    # boundary after that finds the conn dead
    wait_for(lambda: not lib.brpc_tpu_torch_fab_alive(h), 5)
    rcs += [st.write(IOBuf(mk(seq)), timeout=30) for seq in range(4, 8)]
    degraded = s.bulk_bytes_sent
    epoch = wait_for(lambda: s.bulk_epoch() >= 2) and s.bulk_epoch()
    rcs += [st.write(IOBuf(mk(seq)), timeout=30) for seq in range(8, 12)]
    st.close()
    out["death"] = {"rcs": rcs, "healthy": healthy, "degraded": degraded,
                    "after": s.bulk_bytes_sent, "epoch": epoch,
                    "failed": s.failed, "inline": route.route_stats().get(
                        "inline_bytes", 0)}
    ch.close()
    # (b) a sever mid-writev: that stream fails, the socket lives, a new
    # stream runs over the revived conn
    plan = fi.FabricFaultPlan(seed=3, bulk_sever_after_bytes=CHUNK
                              + CHUNK // 2)
    fi.install_fabric(plan)
    ch = channel(1)
    st = open_stream(ch)
    s = client_sock(1)
    fi.install_fabric(None)
    first = st.write(IOBuf(mk(0)), timeout=30)
    failed_cleanly = False
    try:
        for seq in range(1, 6):
            st.write(IOBuf(mk(seq)), timeout=30)
    except (ConnectionError, OSError):
        failed_cleanly = True
    r = {"first": first, "failed_cleanly": failed_cleanly,
         "closed": st.closed, "injected": plan.injected["bulk_chaos"]}
    r["epoch"] = wait_for(lambda: s.bulk_epoch() >= 2) and s.bulk_epoch()
    st2 = open_stream(ch)
    before = s.bulk_bytes_sent
    r["rcs2"] = [st2.write(IOBuf(mk(seq)), timeout=30) for seq in range(4)]
    r["gain"] = s.bulk_bytes_sent - before
    st2.close()
    r["failed"] = s.failed
    out["sever"] = r
    ch.close()
""" + _FINISH

# test_chaos_fabric.py:937 and :1010
_BULK_DROP_REFUSE = r"""
flags.set_flag("ici_fabric_shm", False)
flags.set_flag("ici_bulk_claim_timeout_s", 1.0)
""" + _COMMON + r"""
if pid == 1:
    # (c) a dropped bulk frame: the claim times out, that stream fails,
    # the socket survives
    ch = channel(0)
    st = open_stream(ch)
    s = client_sock(0)
    ok0 = st.write(IOBuf(mk(0)), timeout=30)
    # the server's conn black-holes the next frame it receives
    put("drop_armed_req", 1)
    get("drop_armed", 30)
    rcs = []
    try:
        for seq in range(1, 4):
            rcs.append(st.write(IOBuf(mk(seq)), timeout=30))
    except (ConnectionError, OSError):
        rcs.append("raised")
    closed = wait_for(lambda: st.closed, 15)
    out["drop"] = {"ok0": ok0, "rcs": rcs, "closed": closed,
                   "failed": s.failed}
    ch.close()
if pid == 0:
    get("drop_armed_req", 30)
    sv = [x for x in fabric_socks() if x.is_server_side
          and x.local_dev == 0][0]
    out["armed"] = fi.chaos_plane(sv, "bulk", fi.BLACKHOLE, 1)
    put("drop_armed", 1)
barrier("dropped", 60)
if pid == 0:
    fi.install_fabric(fi.FabricFaultPlan(seed=11, refuse_bulk_handshakes=1))
barrier("plan", 30)
if pid == 1:
    # (d) a refused re-establishment: the prober backs off and retries
    ch = channel(1)
    payload = os.urandom(CHUNK)
    e0 = echo(ch, payload)
    s = client_sock(1)
    h, lib = s._bulk, s._blib
    lib.brpc_tpu_torch_fab_chaos(h, fi.CHAOS_SEVER_NOW, 0)
    wait_for(lambda: not lib.brpc_tpu_torch_fab_alive(h), 5)
    e1 = echo(ch, payload)
    epoch = wait_for(lambda: s.bulk_epoch() >= 2) and s.bulk_epoch()
    before = s.bulk_bytes_sent
    e2 = echo(ch, payload)
    out["refuse"] = {"errs": [e0, e1, e2], "epoch": epoch,
                     "gain": s.bulk_bytes_sent - before, "failed": s.failed,
                     "failures": s.describe_planes()["bulk"][
                         "probe_failures"]}
    ch.close()
barrier("refused", 60)
if pid == 0:
    out["injected"] = dict(fi.fabric_active().injected)
    fi.install_fabric(None)
""" + _FINISH

# test_chaos_fabric.py:1675 (the ring's slow/kill/black-hole matrix)
_SHM_MATRIX = r"""
flags.set_flag("ici_bulk_claim_timeout_s", 1.0)
""" + _COMMON + r"""
if pid == 1:
    ch = channel(0)
    payload = os.urandom(CHUNK)
    errs = [echo(ch, payload)]
    s = client_sock(0)
    r = {"bound": s.shm_bound()}
    base = route.plane_stats()
    plan = fi.FabricFaultPlan(plane_slow_ms={"shm": 40})
    t0 = time.monotonic()
    with fi.inject_fabric(plan):
        errs.append(echo(ch, payload))
    r["slow_s"] = time.monotonic() - t0
    r["slow_injected"] = plan.injected["plane_slow"]
    r["slow_downs"] = route.plane_stats().get("shm_down", 0) \
        - base.get("shm_down", 0)
    # kill the ring and slow the bulk conn: the bytes ride bulk, only the
    # ring degrades
    bulk0 = s.bulk_bytes_sent
    r["armed"] = (fi.chaos_plane(s, "shm", fi.KILL),
                  fi.chaos_plane(s, "bulk", fi.SLOW, 150))
    t0 = time.monotonic()
    errs.append(echo(ch, payload))
    r["kill_s"] = time.monotonic() - t0
    with s._bulk_lock:
        bh, blib = s._bulk, s._blib
    blib.brpc_tpu_torch_fab_chaos(bh, fi.CHAOS_CLEAR, 0)
    now = route.plane_stats()
    r["downs"] = (now.get("shm_down", 0) - base.get("shm_down", 0),
                  now.get("bulk_down", 0) - base.get("bulk_down", 0))
    r["bulk_gain"] = s.bulk_bytes_sent - bulk0
    t0 = time.monotonic()
    wait_for(lambda: s.describe_planes()["shm"]["state"] == "up")
    r["revive_s"] = time.monotonic() - t0
    sent = s.shm_bytes_sent
    errs.append(echo(ch, payload))
    r["shm_gain"] = s.shm_bytes_sent - sent
    now = route.plane_stats()
    r["revived"] = now.get("shm_revived", 0) - base.get("shm_revived", 0)
    r["ramp"] = now.get("shm_ramp", 0) - base.get("shm_ramp", 0)
    r["errs"] = [e for e in errs if e]
    r["failed"] = s.failed
    out["matrix"] = r
    put("blackhole_req", 1)
    # a black-holed ring on the server: our stream to it fails, the
    # sockets live
    get("blackhole_armed", 30)
    st = open_stream(ch)
    rcs = []
    try:
        for seq in range(6):
            rcs.append(st.write(IOBuf(mk(seq)), timeout=10))
    except (ConnectionError, OSError):
        rcs.append("raised")
    out["blackhole"] = {"closed": wait_for(lambda: st.closed, 15),
                        "failed": s.failed}
    ch.close()
if pid == 0:
    get("blackhole_req", 60)
    sv = [x for x in fabric_socks() if x.is_server_side][0]
    wait_for(lambda: sv.shm_bound(), 15)
    out["bh_armed"] = fi.chaos_plane(sv, "shm", fi.BLACKHOLE, 4)
    put("blackhole_armed", 1)
""" + _FINISH

# test_chaos_fabric.py:1265, the port's difference: a refused device post
# fails EINTERNAL, and nothing crosses on the bulk conn, the ring or inline
_DEVICE_REFUSAL = r"""
flags.set_flag("ici_fabric_shm", False)
""" + _COMMON + r"""
flags.set_flag("ici_device_plane_threshold", 64 * 1024)
if pid == 1:
    ch = channel(0)
    s0 = route.route_stats()
    plan = fi.FabricFaultPlan(device_plane_fail_posts=1)
    with fi.inject_fabric(plan):
        err = echo(ch, os.urandom(CHUNK), device=True)
    s1 = route.route_stats()
    moved = {k: s1.get(k, 0) - s0.get(k, 0) for k in
             ("uds_bytes", "tcp_bytes", "shm_bytes", "device_bytes")}
    out["refusal"] = {"err": err, "moved": moved,
                      "injected": plan.injected["device_plane"]}
    ch.close()
""" + _FINISH


@pytest.fixture(scope="module")
def two_proc():
    from tests.torch_procs import ok, run_procs
    scen = {"streams": _BULK_STREAMS, "drop": _BULK_DROP_REFUSE,
            "matrix": _SHM_MATRIX, "device": _DEVICE_REFUSAL}
    with ThreadPoolExecutor(len(scen)) as ex:
        futs = {k: ex.submit(run_procs, body, 2, 110)
                for k, body in scen.items()}
        res = {k: ok(f.result()) for k, f in futs.items()}
    for rs in res.values():
        for r in rs:
            assert r["foreign"] == []
            left = [n for n in r["made"] if os.path.exists(f"/dev/shm/{n}")]
            assert left == [], left
    return res


def test_chaos_bulk_death_midstream_inline_fallback_then_revival(two_proc):
    srv, cli = two_proc["streams"]
    r = cli["death"]
    assert r["rcs"] == [0] * 12 and r["failed"] is False
    assert r["healthy"] >= 4 * 256 * 1024
    assert r["degraded"] == r["healthy"]          # rode inline meanwhile
    assert r["epoch"] >= 2
    assert r["after"] >= r["degraded"] + 4 * 256 * 1024
    assert srv["sinks"][0] == [12, 0, True]


def test_chaos_mid_writev_sever_fails_stream_cleanly_socket_survives(
        two_proc):
    srv, cli = two_proc["streams"]
    r = cli["sever"]
    assert r["injected"] >= 1 and r["first"] == 0
    assert r["failed_cleanly"] or r["closed"]
    assert r["epoch"] >= 2 and r["rcs2"] == [0] * 4
    assert r["gain"] >= 4 * 256 * 1024 and r["failed"] is False
    assert srv["sinks"][2][1:] == [0, True]
    assert not any(srv["server_failed"])


def test_chaos_lost_bulk_bytes_fail_stream_only(two_proc):
    srv, cli = two_proc["drop"]
    assert srv["armed"] is True
    r = cli["drop"]
    assert r["ok0"] == 0 and r["closed"] is True and r["failed"] is False


def test_chaos_refused_bulk_reestablish_retries_with_backoff(two_proc):
    srv, cli = two_proc["drop"]
    r = cli["refuse"]
    assert r["errs"] == [None, None, None]
    assert r["epoch"] >= 2 and r["gain"] >= 256 * 1024
    assert r["failed"] is False
    assert srv["injected"]["refuse_bulk"] == 1


def test_chaos_shm_plane_matrix_slow_kill_blackhole_zero_failures(two_proc):
    srv, cli = two_proc["matrix"]
    r = cli["matrix"]
    assert r["bound"] and r["errs"] == [] and r["failed"] is False
    assert r["slow_injected"] >= 1 and r["slow_downs"] == 0
    assert r["armed"] == [True, True]
    assert r["downs"] == [1, 0]                  # a slow bulk conn lives
    assert r["bulk_gain"] >= 256 * 1024
    assert r["kill_s"] >= 0.1
    assert r["revived"] >= 1 and r["shm_gain"] >= 256 * 1024
    assert r["ramp"] >= 1
    assert srv["bh_armed"] is True
    assert cli["blackhole"] == {"closed": True, "failed": False}


def test_chaos_device_plane_refusal_fails_einternal_nothing_on_bulk(
        two_proc):
    srv, cli = two_proc["device"]
    r = cli["refusal"]
    assert r["injected"] == 1
    assert r["err"][0] == terrors.EINTERNAL, r["err"]
    assert r["moved"] == {"uds_bytes": 0, "tcp_bytes": 0, "shm_bytes": 0,
                          "device_bytes": 0}


def test_phase20_rehearsal_on_cpu():
    """``chip_smoke.py`` phase 20 on a CPU mesh at a small size: the
    three gbps routes, the verified streams, the mixed frame's kinds and
    launch counts, every fault leg with 0 failed calls, nothing left."""
    import chip_smoke as cs
    r = cs.phase_tiers(
        device="cpu", TIER_GB_CHUNK=1 << 20, TIER_GB_CALLS=6,
        TIER_GB_PASSES=2, TIER_GB_RING=16 << 20,
        TIER_GB_STRIPE_RING=8 << 20, TIER_ST_N=24, TIER_ST_PASSES=2,
        TIER_MIX_CALLS=3, TIER_MIX_BIG=256 << 10,
        TIER_FAULT_CALLS=8, TIER_FAULT_PAYLOAD=256 << 10)
    assert r["launches"] == r["received"] == 3
    assert r["foreign"] == [] and r["segments_left"] == []
