"""The port's same-host shm ring (``brpc_tpu_torch/csrc/fabric_native.cpp``)
held against the JAX package's (``native/fabric.cpp``).

  * ring units: ``tests/test_shm.py``'s ring and striped-ring units, run
    on both libraries (wraparound and gather, out-of-order release,
    the full ring's doorbell, oversize and wrap-unfittable frames, the
    dead ring, the chaos modes, unlink while mapped, a claim held over
    close);
  * the layout: a segment one library creates, the other attaches, bytes
    both ways, one stripe and four;
  * the port's segment names (``brpc_tpu_torch_shm.<process>.<nonce>``):
    a nonce never repeats, and a segment a killed process left behind
    does not block a create;
  * zero-copy delivery: a kind-5 claim is a CPU tensor over the ring
    slot, released once, when its last view dies (the ring's occupancy
    is the buffer count); with host delivery off, an owned copy;
  * two processes (``tests/torch_procs.py``): ``tests/test_shm.py``'s
    eight cases (``:740-1191``) on the port's fabric, run as four
    scenarios at once.

Nothing here leaves a port segment in /dev/shm (the module fixture
checks).
"""
from __future__ import annotations

import ctypes
import gc
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil import native as tnative
from brpc_tpu_torch.ici import fabric as tfab

u8p = ctypes.POINTER(ctypes.c_uint8)


class _Shm:
    """One library's ring API under short names (``shm_send`` ...)."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            from brpc_tpu.butil import native
            self.lib = native.load()
            self.prefix = "brpc_tpu_"
        else:
            self.lib = tnative.load_fabric()
            self.prefix = "brpc_tpu_torch_"
        assert self.lib is not None, name

    def __getattr__(self, short):
        return getattr(self.lib, self.prefix + short)


LIBS = {}


def _lib(name) -> _Shm:
    if name not in LIBS:
        LIBS[name] = _Shm(name)
    return LIBS[name]


BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def _ring_pair(L, tag: str, ring_bytes: int, stripes: int = 1,
               attach_with=None):
    """Create and attach one segment in this process (two mappings of the
    same pages, as two processes see them) and unlink it."""
    name = f"{tfab.SHM_PREFIX}t.{tag}.{os.getpid()}.{os.urandom(4).hex()}"
    if stripes > 1:
        h0 = L.shm_create2(name.encode(), ring_bytes, stripes)
    else:
        h0 = L.shm_create(name.encode(), ring_bytes)
    assert h0, "create failed"
    A = attach_with or L
    h1 = A.shm_attach(name.encode())
    assert h1, "attach failed on a just-created segment"
    assert A.shm_unlink(name.encode()) == 0
    assert not os.path.exists(f"/dev/shm/{name}")
    return h0, h1


def _send(L, h, uuid, payload: bytes, timeout_us=5_000_000) -> int:
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    return L.shm_send(h, uuid, buf, len(payload), timeout_us)


def _recv(L, h, uuid, timeout_us=5_000_000):
    out, olen = u8p(), ctypes.c_uint64()
    rc = L.shm_recv(h, uuid, timeout_us, ctypes.byref(out),
                    ctypes.byref(olen))
    return rc, out, olen.value


def _stats(L, h):
    st = (ctypes.c_uint64 * 6)()
    assert L.shm_stats(h, st, 6) == 6
    return {"bytes_out": st[0], "bytes_in": st[1], "tx_occ": st[2],
            "rx_occ": st[3], "db_waits": st[4], "ring_bytes": st[5]}


@pytest.fixture(scope="module", autouse=True)
def no_segments_left():
    yield
    mine = [n for n in tfab.shm_segments_on_disk()
            if f".{os.getpid()}." in n]
    assert mine == [], mine


# ---------------------------------------------------------------------------
# Ring units, both libraries.
# ---------------------------------------------------------------------------

@BOTH
def test_byte_exact_incl_wraparound_and_gather(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "wrap", 1 << 20)
    payload = bytes(range(256)) * 1000
    for i in range(24):
        if i % 2 == 0:
            assert _send(L, h0, 100 + i, payload) == 0
        else:
            b = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            base = ctypes.addressof(b)
            ptrs = (ctypes.c_void_p * 3)(base, base + 1000, base + 50000)
            lens = (ctypes.c_uint64 * 3)(1000, 49000, len(payload) - 50000)
            assert L.shm_sendv(h0, 100 + i, ptrs, lens, 3, 5_000_000) == 0
        rc, out, n = _recv(L, h1, 100 + i)
        assert rc == 0 and n == len(payload)
        assert ctypes.string_at(out, n) == payload
        L.shm_release(h1, out, n)
    assert _stats(L, h1)["bytes_in"] == 24 * len(payload)
    L.shm_close(h0)
    L.shm_close(h1)


@BOTH
def test_out_of_order_release_advances_head_in_order(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "ooo", 1 << 20)
    payload = b"z" * 100_000
    foot = 16 + (len(payload) + 15) // 16 * 16
    claims = []
    for i in range(3):
        assert _send(L, h0, i + 1, payload) == 0
        rc, out, n = _recv(L, h1, i + 1)
        assert rc == 0
        claims.append((out, n))
    L.shm_release(h1, claims[1][0], claims[1][1])
    assert _stats(L, h1)["rx_occ"] >= 3 * foot
    L.shm_release(h1, claims[0][0], claims[0][1])
    assert _stats(L, h1)["rx_occ"] == foot
    L.shm_release(h1, claims[2][0], claims[2][1])
    assert _stats(L, h1)["rx_occ"] == 0
    L.shm_close(h0)
    L.shm_close(h1)


@BOTH
def test_full_ring_blocks_then_doorbell_wakes(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "full", 1 << 20)
    payload = b"f" * 400_000
    assert _send(L, h0, 1, payload) == 0
    assert _send(L, h0, 2, payload) == 0
    t0 = time.monotonic()
    assert _send(L, h0, 3, payload, timeout_us=250_000) == -1
    assert 0.2 < time.monotonic() - t0 < 3.0

    def drain():
        time.sleep(0.25)
        for i in (1, 2):
            rc, out, n = _recv(L, h1, i)
            assert rc == 0
            L.shm_release(h1, out, n)
    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t0 = time.monotonic()
    assert _send(L, h0, 3, payload, timeout_us=10_000_000) == 0
    assert time.monotonic() - t0 >= 0.2
    t.join()
    assert _stats(L, h0)["db_waits"] > 0
    rc, out, n = _recv(L, h1, 3)
    assert rc == 0
    L.shm_release(h1, out, n)
    L.shm_close(h0)
    L.shm_close(h1)


@BOTH
def test_oversize_and_wrap_unfittable_frames_fail_fast_ring_alive(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "big", 1 << 20)
    assert _send(L, h0, 1, b"x" * (2 << 20), timeout_us=0) == -3
    assert L.shm_alive(h0) == 1
    assert _send(L, h0, 2, b"a" * 400_000) == 0
    rc, out, n = _recv(L, h1, 2)
    assert rc == 0
    L.shm_release(h1, out, n)
    t0 = time.monotonic()
    assert _send(L, h0, 3, b"b" * 700_000, timeout_us=10_000_000) == -3
    assert time.monotonic() - t0 < 1.0
    assert L.shm_alive(h0) == 1
    assert _send(L, h0, 4, b"c" * 100_000) == 0
    rc, out, n = _recv(L, h1, 4)
    assert rc == 0 and n == 100_000
    L.shm_release(h1, out, n)
    L.shm_close(h0)
    L.shm_close(h1)


@BOTH
def test_dead_ring_fails_fast_but_parked_frames_claimable(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "dead", 1 << 20)
    assert _send(L, h0, 7, b"before-death") == 0
    got = {}

    def parked():
        got["rc"] = _recv(L, h1, 999, timeout_us=30_000_000)[0]
    t = threading.Thread(target=parked, daemon=True)
    t.start()
    time.sleep(0.1)
    L.shm_close(h0)
    t.join(5)
    assert not t.is_alive() and got["rc"] == -2
    rc, out, n = _recv(L, h1, 7)
    assert rc == 0 and ctypes.string_at(out, n) == b"before-death"
    L.shm_release(h1, out, n)
    assert _send(L, h1, 8, b"x", timeout_us=100_000) == -1
    L.shm_close(h1)


@BOTH
def test_chaos_drop_and_sever_mid_slot(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "drop", 1 << 20)
    assert L.shm_chaos(h1, 2, 1) == 0              # drop the next frame
    assert _send(L, h0, 1, b"vanishes") == 0
    assert _recv(L, h1, 1, timeout_us=200_000)[0] == -1
    assert L.shm_alive(h1) == 1
    assert _send(L, h0, 2, b"a" * 10_000) == 0
    rc, out, n = _recv(L, h1, 2)
    assert rc == 0 and n == 10_000
    L.shm_release(h1, out, n)
    # a watermark inside the next frame: a partial slot, no publish, the
    # ring dies; the receiver never sees a torn frame
    assert L.shm_chaos(h0, 1, _stats(L, h0)["bytes_out"] + 2_000) == 0
    assert _send(L, h0, 3, b"b" * 10_000) == -1
    assert L.shm_alive(h0) == 0 and L.shm_alive(h1) == 0
    assert _recv(L, h1, 3, timeout_us=5_000_000)[0] == -2
    L.shm_close(h0)
    L.shm_close(h1)


@BOTH
def test_unlink_while_mapped_and_claim_held_over_close(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "hold", 1 << 20)
    for i in range(4):
        payload = bytes([i]) * 50_000
        assert _send(L, h0, i + 1, payload) == 0
        rc, out, n = _recv(L, h1, i + 1)
        assert rc == 0 and ctypes.string_at(out, n) == payload
        L.shm_release(h1, out, n)
    assert _send(L, h0, 9, b"\x5a" * 4096) == 0
    rc, out, n = _recv(L, h1, 9)
    assert rc == 0
    L.shm_close(h0)
    L.shm_close(h1)                        # a claim is out: unmap deferred
    assert out[0] == 0x5A and out[n - 1] == 0x5A
    L.shm_release(h1, out, n)              # the last release unmaps


@BOTH
def test_striped_create_attach_byte_exact_per_stripe(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "stripe", 128 * 1024, stripes=4)
    assert L.shm_stripes(h0) == L.shm_stripes(h1) == 4
    try:
        for stripe in range(4):
            payload = bytes([(stripe * 31 + i) % 251 for i in range(5000)])
            buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            assert L.shm_send2(h0, stripe, 100 + stripe, buf, len(payload),
                               5_000_000) == 0
        for stripe in range(4):
            out, olen = u8p(), ctypes.c_uint64()
            assert L.shm_recv2(h1, stripe, 100 + stripe, 5_000_000,
                               ctypes.byref(out), ctypes.byref(olen)) == 0
            assert ctypes.string_at(out, olen.value) == bytes(
                [(stripe * 31 + i) % 251 for i in range(5000)])
            L.shm_release(h1, out, olen.value)
        st = (ctypes.c_uint64 * 6)()
        total = 0
        for stripe in range(4):
            assert L.shm_stripe_stats(h0, stripe, st, 6) == 6
            assert st[0] == 5000
            total += st[0]
        assert L.shm_stats(h0, st, 6) == 6
        assert st[0] == total and st[5] == 128 * 1024
        one = (ctypes.c_uint8 * 4).from_buffer_copy(b"abcd")
        assert L.shm_send2(h0, 7, 1, one, 4, 1000) == -1
        assert L.shm_alive(h0)
    finally:
        L.shm_close(h0)
        L.shm_close(h1)


@BOTH
def test_stripe_kill_degrades_whole_plane(pkg):
    L = _lib(pkg)
    h0, h1 = _ring_pair(L, "skill", 128 * 1024, stripes=4)
    one = (ctypes.c_uint8 * 64).from_buffer_copy(b"\x5a" * 64)
    assert L.shm_send2(h0, 0, 0x901, one, 64, 1_000_000) == 0
    out, olen = u8p(), ctypes.c_uint64()
    assert L.shm_recv2(h1, 0, 0x901, 1_000_000, ctypes.byref(out),
                       ctypes.byref(olen)) == 0
    assert L.shm_chaos(h0, 5, 2) == 0
    assert L.shm_send2(h0, 2, 0x902, one, 64, 1_000_000) == -1
    assert L.shm_alive(h0) == 0 and L.shm_alive(h1) == 0
    assert L.shm_send2(h0, 1, 0x903, one, 64, 1000) == -1
    o2, l2 = u8p(), ctypes.c_uint64()
    assert L.shm_recv2(h1, 3, 0xBEEF, 5_000_000, ctypes.byref(o2),
                       ctypes.byref(l2)) == -2
    L.shm_close(h0)
    L.shm_close(h1)
    assert ctypes.string_at(out, olen.value) == b"\x5a" * 64
    L.shm_release(h1, out, olen.value)


@BOTH
def test_create2_single_stripe_is_v1_layout(pkg):
    L = _lib(pkg)
    name = f"{tfab.SHM_PREFIX}t.v1.{os.getpid()}.{os.urandom(4).hex()}"
    h0 = L.shm_create2(name.encode(), 64 * 1024, 1)
    assert h0
    try:
        with open(f"/dev/shm/{name}", "rb") as f:
            assert f.read(4) == b"1MHS"
        assert L.shm_stripes(h0) == 1
    finally:
        L.shm_unlink(name.encode())
        L.shm_close(h0)


def test_stripe_resolution_and_uuid_tagging_equal_jax(monkeypatch):
    from brpc_tpu.butil import flags as jflags
    from brpc_tpu.ici import fabric as jfab
    saved = (jflags.get_flag("ici_shm_stripes"),
             tflags.get_flag("ici_shm_stripes"))
    try:
        for n, cores in ((0, 1), (0, 8), (0, 2), (6, 8), (99, 8)):
            jflags.set_flag("ici_shm_stripes", n)
            tflags.set_flag("ici_shm_stripes", n)
            monkeypatch.setattr(jfab._os, "cpu_count", lambda: cores)
            monkeypatch.setattr(tfab.os, "cpu_count", lambda: cores)
            assert tfab._resolve_shm_stripes() == jfab._resolve_shm_stripes()
    finally:
        jflags.set_flag("ici_shm_stripes", saved[0])
        tflags.set_flag("ici_shm_stripes", saved[1])
    for uuid, n in ((0x123, 1), ((3 << 56) | 0x123, 4),
                    ((9 << 56) | 0x123, 4), (0x55, 64)):
        assert tfab.FabricSocket._shm_stripe_of(uuid, n) == \
            jfab.FabricSocket._shm_stripe_of(uuid, n)


# ---------------------------------------------------------------------------
# The layout: one library creates, the other attaches.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("creator,attacher", [("port", "jax"),
                                              ("jax", "port")])
@pytest.mark.parametrize("stripes", [1, 4])
def test_cross_library_attach_both_ways(creator, attacher, stripes):
    C, A = _lib(creator), _lib(attacher)
    h0, h1 = _ring_pair(C, f"x{stripes}", 256 * 1024, stripes=stripes,
                        attach_with=A)
    try:
        assert A.shm_stripes(h1) == C.shm_stripes(h0) == stripes
        for i, (S, hs, R, hr) in enumerate(((C, h0, A, h1),
                                            (A, h1, C, h0)) * 3):
            payload = bytes([(i * 7 + j) % 253 for j in range(20_000 + i)])
            buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            stripe = i % stripes
            out, olen = u8p(), ctypes.c_uint64()
            if stripes > 1:
                assert S.shm_send2(hs, stripe, 50 + i, buf, len(payload),
                                   5_000_000) == 0
                assert R.shm_recv2(hr, stripe, 50 + i, 5_000_000,
                                   ctypes.byref(out),
                                   ctypes.byref(olen)) == 0
            else:
                assert S.shm_send(hs, 50 + i, buf, len(payload),
                                  5_000_000) == 0
                assert R.shm_recv(hr, 50 + i, 5_000_000, ctypes.byref(out),
                                  ctypes.byref(olen)) == 0
            assert ctypes.string_at(out, olen.value) == payload
            R.shm_release(hr, out, olen.value)
        assert _stats(C, h0)["bytes_out"] == _stats(A, h1)["bytes_in"]
        assert _stats(A, h1)["bytes_out"] == _stats(C, h0)["bytes_in"]
    finally:
        C.shm_close(h0)
        A.shm_close(h1)


# ---------------------------------------------------------------------------
# Segment names and zero-copy delivery.
# ---------------------------------------------------------------------------

def _bare_node(pid=0):
    node = tfab.FabricNode()
    node.process_id = pid
    node._shm_ok = True
    node._shm_lib = tnative.load_fabric()
    return node


def test_segment_names_never_repeat_and_stale_segments_do_not_block():
    """The port's names carry a random nonce, so a segment left at
    ``/dev/shm`` by a killed process of the same fabric process id never
    collides with a later exclusive create."""
    node = _bare_node(pid=7)
    stale = f"{tfab.SHM_PREFIX}7.{os.urandom(8).hex()}"
    with open(f"/dev/shm/{stale}", "wb") as f:
        f.write(b"\0" * 4096)                  # left by a killed process
    made = []
    try:
        for _ in range(4):
            h, name, lib = node.create_shm_segment()
            assert h and name.startswith(tfab.SHM_PREFIX + "7.")
            made.append((h, name))
        names = [n for _h, n in made]
        assert len(set(names)) == 4 and stale not in names
        assert not any(n.startswith("brpc_tpu_shm.") for n in names)
        assert set(names) <= set(tfab.shm_segments_on_disk(7))
    finally:
        for h, name in made:
            node.drop_shm_segment(h, name)
        os.unlink(f"/dev/shm/{stale}")
    assert tfab.shm_segments_on_disk(7) == []


def _claim_sock(lib, h, local_dev=0):
    """A FabricSocket holding only what the claim path reads."""
    from brpc_tpu_torch.ici.mesh import IciMesh
    s = object.__new__(tfab.FabricSocket)
    s._bulk_lock = threading.Lock()
    s._shm, s._shm_dead, s._shmlib = h, 0, lib
    s._shm_stripes = s._shm_dead_stripes = 1
    s.shm_bytes_claimed = 0
    s._bulk, s._blib, s.bulk_bytes_claimed = 0, None, 0
    s.mesh = IciMesh(ranks=8, device="cpu")
    s.local_dev = local_dev
    return s


def test_kind5_host_delivery_is_zero_copy_released_by_the_last_view():
    L = _lib("port")
    h0, h1 = _ring_pair(L, "zc", 1 << 20)
    saved = tflags.get_flag("ici_fabric_host_delivery")
    try:
        s = _claim_sock(L.lib, h1)
        payload = bytes(range(256)) * 256              # 64 KiB
        assert _send(L, h0, 0x51, payload) == 0
        t = s._claim_tensor(5, 0x51, len(payload))
        assert t.device.type == "cpu" and t.dtype == torch.uint8
        assert bytes(t.numpy()) == payload
        # zero copy: the tensor reads the ring slot itself
        out, olen = u8p(), ctypes.c_uint64()
        assert t.data_ptr() != 0 and _stats(L, h1)["rx_occ"] > 0
        view = t[1000:2000]
        del t
        gc.collect()
        assert _stats(L, h1)["rx_occ"] > 0, "released under a live view"
        assert bytes(view.numpy()) == payload[1000:2000]
        del view
        gc.collect()
        assert _stats(L, h1)["rx_occ"] == 0, "the last view did not release"
        assert s.shm_bytes_claimed == len(payload)
        # host delivery off: an owned copy on the local rank, the slot
        # retired at once
        tflags.set_flag("ici_fabric_host_delivery", False)
        assert _send(L, h0, 0x52, payload) == 0
        owned = s._claim_tensor(5, 0x52, len(payload))
        gc.collect()
        assert _stats(L, h1)["rx_occ"] == 0
        assert s.mesh.rank_of(owned) == s.local_dev
        assert bytes(owned.numpy()) == payload
        del out, olen
    finally:
        tflags.set_flag("ici_fabric_host_delivery", saved)
        L.shm_close(h0)
        L.shm_close(h1)


# ---------------------------------------------------------------------------
# Two processes: tests/test_shm.py's eight cases on the port's fabric.
# ---------------------------------------------------------------------------

_COMMON = r"""
from brpc_tpu_torch.butil.iobuf import IOBuf
made = []                                  # the segments this process made
_create = node.create_shm_segment

def _recording_create():
    h, name, lib = _create()
    if name:
        made.append(name)
    return h, name, lib

node.create_shm_segment = _recording_create
from brpc_tpu_torch.rpc import fault_injection as fi
flags.set_flag("ici_device_plane_threshold", 1 << 30)   # no kind 4 here
flags.set_flag("ici_bulk_claim_timeout_s", 10.0)
CHUNK = 512 * 1024
PHASE = 4
total = [0]
bad = []
lock = threading.Lock()

def mk(seq, n=CHUNK):
    return bytes([seq % 251]) * n

class Sink(rpc.Service):
    SERVICE_NAME = "Sink"
    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        cntl.response_attachment.append(cntl.request_attachment)
        response.message = "srv:" + request.message
        done()
    @rpc.method(EchoRequest, EchoResponse)
    def Push(self, cntl, request, response, done):
        got = cntl.request_attachment.to_bytes()
        seq = int(request.message)
        with lock:
            total[0] += len(got)
            if got != mk(seq, len(got)) or not got:
                bad.append(seq)
        response.message = str(total[0])
        done()

class StreamSink(rpc.StreamInputHandler):
    def __init__(self, size):
        self.next, self.bad, self.size = 0, 0, size
        self.closed = threading.Event()
    def on_received_messages(self, sid, msgs):
        for m in msgs:
            if m.to_bytes() != mk(self.next, self.size):
                self.bad += 1
            self.next += 1
    def on_closed(self, sid):
        self.closed.set()

sinks = []

class Streams(rpc.Service):
    SERVICE_NAME = "Streams"
    @rpc.method(EchoRequest, EchoResponse)
    def Start(self, cntl, request, response, done):
        h = StreamSink(int(request.message))
        sinks.append(h)
        rpc.stream_accept(cntl, rpc.StreamOptions(handler=h,
                                                  max_buf_size=8 << 20))
        done()

servers = []
if pid == 0:
    for r in (0, 1):
        srv = rpc.Server(rpc.ServerOptions(native_ici=False))
        srv.add_service(Sink()); srv.add_service(Streams())
        assert srv.start("ici://%d" % r) == 0
        servers.append(srv)
barrier("up", 30)

def channel(rank):
    ch = rpc.Channel()
    ch.init("ici://%d" % rank, options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    return ch

def sock_to(rank):
    return [s for s in fabric_socks() if s.remote_dev == rank
            and not s.failed and not s.is_server_side][0]

def push(ch, seq, n=CHUNK, device=True):
    cntl = rpc.Controller()
    if device:
        cntl.request_attachment.append_device_array(
            mesh.own(torch.full((n,), seq % 251, dtype=torch.uint8), 2))
    else:
        cntl.request_attachment.append(mk(seq, n))
    ch.call_method("Sink.Push", cntl, EchoRequest(message=str(seq)),
                   EchoResponse)
    return None if not cntl.failed() else (seq, cntl.error_code_,
                                           cntl.error_text)

def stream_to(ch, size, nframes, mid=None):
    cntl = rpc.Controller()
    st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=8 << 20))
    ch.call_method("Streams.Start", cntl, EchoRequest(message=str(size)),
                   EchoResponse)
    assert not cntl.failed(), cntl.error_text
    assert st.wait_connected(10)
    rcs = []
    for seq in range(nframes):
        if mid is not None and seq == nframes // 3:
            mid()
        rcs.append(st.write(IOBuf(mk(seq, size)), timeout=30))
    st.close()
    return rcs

def wait_epoch(s, fn, want, t=20):
    end = time.time() + t
    while fn() < want and time.time() < end:
        time.sleep(0.05)
    return fn()

def stripe_bytes():
    return {k: v for k, v in route.route_stats().items()
            if k.startswith("shm_stripe_") and k.endswith("_bytes")}

def server_side_report():
    out = {"bad": bad, "total": total[0],
           "sinks": [(h.next, h.bad, h.closed.is_set()) for h in sinks]}
    socks = [s for s in fabric_socks() if s.is_server_side]
    out["claimed"] = sum(s.shm_bytes_claimed for s in socks)
    out["bulk_claimed"] = sum(s.bulk_bytes_claimed for s in socks)
    return out
"""

_FINISH = r"""
barrier("done", 60)
if pid == 0:
    out.update(server_side_report())
for srv in servers:
    srv.stop()
out["made"] = made
out["foreign"] = foreign()
result(out)
finish()
"""

_PRE = ""

_ROUTE_AND_STREAM = _PRE + _COMMON + r"""
out = {}
if pid == 1:
    ch = channel(0)
    errs = []
    pay = mesh.own((torch.arange(CHUNK) % 251).to(torch.uint8), 2)
    want = bytes(pay.numpy())
    for i in range(4):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(pay)
        resp = ch.call_method("Sink.Echo", cntl,
                              EchoRequest(message="m%d" % i), EchoResponse)
        if cntl.failed() or resp.message != "srv:m%d" % i \
                or cntl.response_attachment.to_bytes() != want:
            errs.append((i, cntl.error_text))
    s = sock_to(0)
    out["route"] = {"errs": errs, "bound": s.shm_bound(),
                    "sent": s.shm_bytes_sent, "claimed": s.shm_bytes_claimed,
                    "bulk": s.bulk_bytes_sent,
                    "epoch": s.describe_shm()["epoch"],
                    "stripes": s.describe_shm()["stripes"],
                    "shm_route": route.route_stats().get("shm_bytes", 0)}
barrier("route_leg", 30)
if pid == 0:
    out["route_srv"] = server_side_report()
if pid == 1:
    sb0 = stripe_bytes()
    rcs = stream_to(ch, 256 * 1024, 24)
    out["stream"] = {"rcs": rcs, "sent": s.shm_bytes_sent,
                     "bulk": s.bulk_bytes_sent}
    sb1 = stripe_bytes()
    out["stream_stripes"] = sorted(k for k in sb1
                                   if sb1[k] != sb0.get(k, 0))
    # unary frames round-robin every stripe of the striped ring
    ch2 = channel(1)
    for i in range(8):
        e = push(ch2, i, 256 * 1024, device=False)
        if e:
            errs.append(e)
    s2 = sock_to(1)
    sb2 = stripe_bytes()
    out["rr_stripes"] = sorted(k for k in sb2 if sb2[k] != sb1.get(k, 0))
    out["rr_bulk"] = s2.bulk_bytes_sent
    ch2.close()
    # a one-stripe ring: the plain shm row only
    flags.set_flag("ici_shm_stripes", 1)
    ch.close()
    ch = channel(0)
    e = push(ch, 1, device=False)
    s = sock_to(0)
    out["one"] = {"err": e, "stripes": s.describe_shm()["stripes"],
                  "moved": stripe_bytes() == sb2}
    ch.close()
""" + _FINISH

_KILL = _PRE + _COMMON + r"""
out = {}
if pid == 1:
    for leg, rank in (("kill", 0), ("crash", 1)):
        ch = channel(rank)
        errs = []
        seq = 0
        for _ in range(PHASE):
            errs.append(push(ch, seq)); seq += 1
        s = sock_to(rank)
        r = {"epoch0": s.shm_epoch(), "shm0": s.shm_bytes_sent}
        bulk_before = s.bulk_bytes_sent
        with s._bulk_lock:
            h, lib = s._shm, s._shmlib
        if leg == "kill":
            lib.brpc_tpu_torch_shm_chaos(h, fi.CHAOS_SEVER_NOW, 0)
        else:
            lib.brpc_tpu_torch_shm_chaos(h, fi.CHAOS_SEVER_AFTER_OUT_BYTES,
                                         s.shm_bytes_sent + CHUNK // 2)
        t0 = time.monotonic()
        for _ in range(PHASE):
            errs.append(push(ch, seq)); seq += 1
        r["bulk_gain"] = s.bulk_bytes_sent - bulk_before
        r["epoch"] = wait_epoch(s, s.shm_epoch, 2)
        r["revive_s"] = time.monotonic() - t0
        shm_before = s.shm_bytes_sent
        for _ in range(PHASE):
            errs.append(push(ch, seq)); seq += 1
        r["shm_gain"] = s.shm_bytes_sent - shm_before
        r["failed"] = s.failed
        r["errs"] = [e for e in errs if e]
        r["planes"] = route.plane_stats()
        out[leg] = r
        ch.close()
""" + _FINISH

_REFUSE_AND_STREAM_KILL = _PRE + _COMMON + r"""
out = {}
if pid == 0:
    plan = fi.FabricFaultPlan(refuse_shm_handshakes=1)
    fi.install_fabric(plan)
barrier("plan", 30)
if pid == 1:
    ch = channel(0)
    errs = [push(ch, i) for i in range(3)]
    s = sock_to(0)
    out["refuse"] = {"errs": [e for e in errs if e], "bound": s.shm_bound(),
                     "bulk": s.bulk_bytes_sent, "shm": s.shm_bytes_sent,
                     "uds": route.route_stats().get("uds_bytes", 0)}
    ch.close()
barrier("refused", 30)
if pid == 0:
    out["injected"] = dict(fi.fabric_active().injected)
    fi.install_fabric(None)
barrier("cleared", 30)
if pid == 1:
    flags.set_flag("ici_stream_desc_batch", 4)
    ch = channel(1)
    def kill():
        sk = sock_to(1)
        with sk._bulk_lock:
            h, lib = sk._shm, sk._shmlib
        lib.brpc_tpu_torch_shm_chaos(h, fi.CHAOS_SEVER_NOW, 0)
    rcs = stream_to(ch, 256 * 1024, 18, mid=kill)
    s = sock_to(1)
    out["stream_kill"] = {"rcs": rcs, "epoch": wait_epoch(s, s.shm_epoch, 2),
                          "failed": s.failed, "bulk": s.bulk_bytes_sent}
    ch.close()
""" + _FINISH

_STRIPE_KILL = _PRE + _COMMON + r"""
flags.set_flag("ici_shm_stripes", 4)
out = {}
if pid == 1:
    ch = channel(0)
    errs = []
    seq = 0
    for _ in range(PHASE):
        errs.append(push(ch, seq)); seq += 1
    s = sock_to(0)
    epoch0 = s.shm_epoch()
    stripes0 = s.describe_shm()["stripes"]
    with s._bulk_lock:
        h, lib = s._shm, s._shmlib
    assert lib.brpc_tpu_torch_shm_chaos(h, 5, 1) == 0
    for _ in range(2 * PHASE):
        errs.append(push(ch, seq)); seq += 1
    out["stripe_kill"] = {
        "errs": [e for e in errs if e], "stripes0": stripes0,
        "bulk": s.bulk_bytes_sent, "shm": s.shm_bytes_sent,
        "epoch": wait_epoch(s, s.shm_epoch, epoch0 + 1),
        "epoch0": epoch0, "stripes": s.describe_shm()["stripes"],
        "failed": s.failed}
    ch.close()
""" + _FINISH


@pytest.fixture(scope="module")
def two_proc():
    from tests.torch_procs import ok, run_procs
    scen = {"route": _ROUTE_AND_STREAM, "kill": _KILL,
            "refuse": _REFUSE_AND_STREAM_KILL, "stripe": _STRIPE_KILL}
    with ThreadPoolExecutor(len(scen)) as ex:
        futs = {k: ex.submit(run_procs, body, 2, 100)
                for k, body in scen.items()}
        res = {k: ok(f.result()) for k, f in futs.items()}
    for rs in res.values():
        for r in rs:
            assert r["foreign"] == []
            left = [n for n in r["made"] if os.path.exists(f"/dev/shm/{n}")]
            assert left == [], left
    return res


def test_shm_route_carries_attachments_byte_exact(two_proc):
    srv, cli = two_proc["route"]
    r = cli["route"]
    assert r["errs"] == [] and r["bound"] and r["epoch"] == 1
    assert r["sent"] >= 4 * 512 * 1024 and r["claimed"] >= 4 * 512 * 1024
    assert r["bulk"] == 0 and r["shm_route"] >= 4 * 512 * 1024
    rs = srv["route_srv"]
    assert rs["claimed"] >= 4 * 512 * 1024 and rs["bulk_claimed"] == 0


def test_shm_segment_kill_falls_back_to_bulk_and_revives(two_proc):
    srv, cli = two_proc["kill"]
    r = cli["kill"]
    assert r["errs"] == [] and r["epoch0"] == 1
    assert r["bulk_gain"] >= 512 * 1024
    assert r["epoch"] >= 2 and r["shm_gain"] >= 3 * 512 * 1024
    assert r["failed"] is False
    assert srv["bad"] == []


def test_shm_producer_crash_mid_slot_falls_back_and_revives(two_proc):
    srv, cli = two_proc["kill"]
    r = cli["crash"]
    assert r["errs"] == [] and r["bulk_gain"] >= 512 * 1024
    assert r["epoch"] >= 2 and r["shm_gain"] >= 3 * 512 * 1024
    assert r["failed"] is False
    assert srv["total"] == 2 * 3 * 4 * 512 * 1024 and srv["bad"] == []


def test_shm_refused_handshake_degrades_to_bulk(two_proc):
    srv, cli = two_proc["refuse"]
    r = cli["refuse"]
    assert r["errs"] == [] and r["bound"] is False and r["shm"] == 0
    assert r["bulk"] >= 3 * 512 * 1024 and r["uds"] >= 3 * 512 * 1024
    assert srv["injected"]["refuse_shm"] == 1


def test_streaming_rides_shm_ring_byte_exact(two_proc):
    srv, cli = two_proc["route"]
    st = cli["stream"]
    assert st["rcs"] == [0] * 24 and st["bulk"] == 0
    assert st["sent"] >= 24 * 256 * 1024
    assert srv["sinks"][0][:2] == [24, 0]


def test_shm_kill_mid_stream_with_batched_descriptors_loses_nothing(
        two_proc):
    srv, cli = two_proc["refuse"]
    r = cli["stream_kill"]
    assert r["rcs"] == [0] * 18 and r["failed"] is False
    assert r["epoch"] >= 2
    nxt, nbad, closed = srv["sinks"][-1]
    assert (nxt, nbad, closed) == (18, 0, True)


def test_striped_shm_round_robin_and_stream_affinity_2proc(two_proc):
    srv, cli = two_proc["route"]
    assert cli["route"]["stripes"] == 4
    assert len(cli["rr_stripes"]) == 4, cli["rr_stripes"]
    assert cli["rr_bulk"] == 0
    assert len(cli["stream_stripes"]) == 1, cli["stream_stripes"]
    one = cli["one"]
    assert one["err"] is None and one["stripes"] == 1 and one["moved"]


def test_striped_shm_stripe_kill_degrades_in_frame_and_revives(two_proc):
    srv, cli = two_proc["stripe"]
    r = cli["stripe_kill"]
    assert r["errs"] == [] and r["stripes0"] == 4
    assert r["bulk"] >= 512 * 1024
    assert r["epoch"] > r["epoch0"] and r["stripes"] == 4
    assert r["failed"] is False
    assert srv["bad"] == []
