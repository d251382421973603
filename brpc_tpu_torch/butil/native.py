"""ctypes loader and ABI of the port's native core.

The core is ``csrc/ici_native.cpp`` (the ici:// plane) and
``csrc/rpc_native.cpp`` (the TCP server, channel and pool with their bench
entries), one library, with ``trpc_codec.h`` (the one meta codec and TRPC
framing both use), ``flat_map.h`` and ``tsan_compat.h`` beside them: host
C++, not a kernel.  At first use ``g++ -O2 -fPIC -shared -pthread`` builds
it into ``_build/`` beside the package, named by a digest of the sources
and the flags, so an edit to any of them builds a fresh library instead of
loading a stale one.
Concurrent first uses (test workers, several processes) agree through a
file lock: one builds to a temporary name and renames it into place, the
others wait and load the result.  Nothing is built or loaded when a module
is imported.

The library is built with hidden visibility and ``-Bsymbolic``: its
listener registry and every internal symbol are its own, even in a
process that has loaded another copy of the same datapath.

The ici plane's symbols, the TCP datapath's (``brpc_tpu_nserver_*``,
``brpc_tpu_nchannel_*``, ``brpc_tpu_npool_*``, the ``brpc_tpu_native_*``
bench entries) and ``brpc_tpu_buf_free`` are bound.

The fabric's same-host tiers are a second library of their own,
``csrc/fabric_native.cpp`` (the bulk conn and the shm ring, symbols
``brpc_tpu_torch_fab_*`` and ``brpc_tpu_torch_shm_*``), built the same way
into ``_build/libfabric_native-<digest>.so`` by :func:`load_fabric`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ici_native.cpp", "rpc_native.cpp", "trpc_codec.h", "flat_map.h",
           "tsan_compat.h")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-pthread", "-std=c++17",
             "-fvisibility=hidden", "-Wl,-Bsymbolic"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_load_error = ""


class IciSegC(ctypes.Structure):
    """Attachment segment descriptor of the native ici plane (the SGE of a
    zero-copy post).  Host segments name a span of the att_host byte
    stream; device segments name a registry key."""
    _fields_ = [("key", ctypes.c_uint64),
                ("nbytes", ctypes.c_uint64),
                ("dev", ctypes.c_int32),
                ("is_dev", ctypes.c_int32)]


class IciCallOut(ctypes.Structure):
    """The out-block of one unary ici call.  ``err_text`` is a raw pointer
    (c_void_p, not c_char_p: the automatic bytes conversion would lose the
    pointer the caller must free)."""
    _fields_ = [("resp", ctypes.POINTER(ctypes.c_uint8)),
                ("resp_len", ctypes.c_uint64),
                ("att", ctypes.POINTER(ctypes.c_uint8)),
                ("att_len", ctypes.c_uint64),
                ("segs", ctypes.POINTER(IciSegC)),
                ("nsegs", ctypes.c_uint64),
                ("err_text", ctypes.c_void_p),
                ("retry_after_ms", ctypes.c_uint64),
                # native attachment custody (call4): the response seg list
                # parked under att_handle; seg0_* mirrors segs[0] so the
                # one-seg shape needs no pointer (segs stays NULL then)
                ("att_handle", ctypes.c_uint64),
                ("seg0_key", ctypes.c_uint64),
                ("seg0_nbytes", ctypes.c_uint64),
                ("seg0_dev", ctypes.c_int32),
                ("_pad", ctypes.c_int32)]


class IciReqC(ctypes.Structure):
    """One request of the batched upcall: a single ctypes crossing hands
    the handler tier an array of these.  Pointers are borrowed for the
    upcall; seg keys are taken by Python during it (or stay parked under
    ``att_handle``)."""
    _fields_ = [("token", ctypes.c_uint64),
                ("method", ctypes.c_char_p),
                ("payload", ctypes.POINTER(ctypes.c_uint8)),
                ("payload_len", ctypes.c_uint64),
                ("att_host", ctypes.POINTER(ctypes.c_uint8)),
                ("att_host_len", ctypes.c_uint64),
                ("segs", ctypes.POINTER(IciSegC)),
                ("nsegs", ctypes.c_uint64),
                ("log_id", ctypes.c_uint64),
                ("recv_ns", ctypes.c_int64),
                ("peer_dev", ctypes.c_int32),
                ("_pad", ctypes.c_int32),
                # admission meta (priority wire-encoded: 0 = unset,
                # 1..N = band 0..N-1)
                ("tenant", ctypes.c_char_p),
                ("deadline_left_ms", ctypes.c_uint64),
                ("priority", ctypes.c_int32),
                ("_pad2", ctypes.c_int32),
                ("att_handle", ctypes.c_uint64),
                ("seg0_key", ctypes.c_uint64),
                ("seg0_nbytes", ctypes.c_uint64),
                ("seg0_dev", ctypes.c_int32),
                ("_pad3", ctypes.c_int32)]


class IciRespC(ctypes.Structure):
    """One response of ``brpc_tpu_ici_respond_batch``.  Seg custody moves
    to native on the call; native releases it on every drop path."""
    _fields_ = [("token", ctypes.c_uint64),
                ("err", ctypes.c_uint64),
                ("err_text", ctypes.c_char_p),
                ("data", ctypes.POINTER(ctypes.c_uint8)),
                ("len", ctypes.c_uint64),
                ("att_host", ctypes.POINTER(ctypes.c_uint8)),
                ("att_host_len", ctypes.c_uint64),
                ("segs", ctypes.POINTER(IciSegC)),
                ("nsegs", ctypes.c_uint64),
                ("retry_after_ms", ctypes.c_uint64),
                # nonzero: pass a parked entry back as this response's
                # attachment (segs ignored)
                ("att_handle", ctypes.c_uint64)]


# relocation upcall: (key, target_dev, err, err_cap) -> new key; 0 is a
# failure, its reason written NUL-terminated into err (err_cap bytes)
_ICI_RELOCATE_FN = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.c_uint64,
                                    ctypes.c_int32, ctypes.c_void_p,
                                    ctypes.c_uint32)
# release upcall: native custody of a key ends on a drop path
_ICI_RELEASE_FN = ctypes.CFUNCTYPE(None, ctypes.c_uint64)
# batched request upcall: (reqs, n)
_ICI_BATCH_FN = ctypes.CFUNCTYPE(None, ctypes.POINTER(IciReqC),
                                 ctypes.c_uint64)
# TCP server request upcall: (token, method, payload, payload_len, att,
# att_len, log_id); the token is answered with brpc_tpu_nserver_respond
_NREQ_FN = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                            ctypes.c_uint64)
# TCP channel async completion: (user, error_code, err_text, resp,
# resp_len, att, att_len); fires once, from the channel's reader thread
_ASYNC_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64,
                             ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_uint8),
                             ctypes.c_uint64,
                             ctypes.POINTER(ctypes.c_uint8),
                             ctypes.c_uint64)


FABRIC_SOURCES = ("fabric_native.cpp", "flat_map.h", "tsan_compat.h")


def source_digest(sources=SOURCES) -> str:
    h = hashlib.sha1()
    for name in sources:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(stem: str = "ici_native", sources=SOURCES) -> Path:
    return BUILD_DIR / f"lib{stem}-{source_digest(sources)}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++); set CXX")
    return cxx


def build(stem: str = "ici_native", sources=SOURCES) -> Path:
    """Build the ``.cpp`` units of ``sources`` into ``lib<stem>`` when no
    library of these sources exists; returns its path.  Raises with the
    compiler's output on failure."""
    lib_path = library_path(stem, sources)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():          # another process built it
                return lib_path
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            units = [CSRC / n for n in sources if n.endswith(".cpp")]
            cmd = [_compiler(), *CXX_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   *map(str, units)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{stem}: build failed "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def load() -> Optional[ctypes.CDLL]:
    """The bound core, built on first use; None when it cannot be built or
    loaded (``load_error()`` says why)."""
    global _lib, _load_error
    lib = _lib
    if lib is not None:
        return lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except Exception as e:
            _load_error = f"{type(e).__name__}: {e}"
            return None
        return _lib


def load_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native ici core unavailable: {_load_error}")
    return lib


def load_error() -> str:
    return _load_error


def available() -> bool:
    return load() is not None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    segp = ctypes.POINTER(IciSegC)
    u64 = ctypes.c_uint64
    lib.brpc_tpu_buf_free.argtypes = [ctypes.c_void_p]
    lib.brpc_tpu_buf_free.restype = None
    lib.brpc_tpu_ici_set_hooks.argtypes = [_ICI_RELOCATE_FN, _ICI_RELEASE_FN]
    lib.brpc_tpu_ici_register_echo.restype = ctypes.c_int
    lib.brpc_tpu_ici_register_echo.argtypes = [u64, ctypes.c_char_p]
    lib.brpc_tpu_ici_requests.restype = u64
    lib.brpc_tpu_ici_requests.argtypes = [u64]
    lib.brpc_tpu_ici_has_listener.restype = ctypes.c_int
    lib.brpc_tpu_ici_has_listener.argtypes = [ctypes.c_int32]
    lib.brpc_tpu_ici_unlisten.argtypes = [u64]
    lib.brpc_tpu_ici_connect.restype = u64
    lib.brpc_tpu_ici_connect.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int64]
    lib.brpc_tpu_ici_close.argtypes = [u64]
    lib.brpc_tpu_ici_window_left.restype = ctypes.c_int64
    lib.brpc_tpu_ici_window_left.argtypes = [u64]
    # call3: admission meta (priority wire-encoded, tenant, remaining
    # deadline); call4: call3 with native custody of the response segs
    # the payload and host-attachment pointers are bound as c_char_p: a
    # bytes object passes by pointer (the core never writes through them
    # and copies before returning)
    call_args = [u64, ctypes.c_char_p, ctypes.c_char_p, u64,
                 ctypes.c_char_p, u64, segp, u64, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
                 ctypes.POINTER(IciCallOut)]
    for name in ("brpc_tpu_ici_call3", "brpc_tpu_ici_call4"):
        fn = getattr(lib, name)
        fn.restype = u64
        fn.argtypes = call_args
    lib.brpc_tpu_ici_att_take.restype = ctypes.c_int64
    lib.brpc_tpu_ici_att_take.argtypes = [u64]
    lib.brpc_tpu_ici_att_dispose.restype = ctypes.c_int
    lib.brpc_tpu_ici_att_dispose.argtypes = [u64]
    lib.brpc_tpu_ici_att_count.restype = u64
    lib.brpc_tpu_ici_att_count.argtypes = []
    lib.brpc_tpu_ici_set_att_handles.restype = ctypes.c_int
    lib.brpc_tpu_ici_set_att_handles.argtypes = [u64, ctypes.c_int]
    lib.brpc_tpu_ici_listen_batch.restype = u64
    lib.brpc_tpu_ici_listen_batch.argtypes = [ctypes.c_int32, _ICI_BATCH_FN]
    lib.brpc_tpu_ici_batch_stats.restype = ctypes.c_int
    lib.brpc_tpu_ici_batch_stats.argtypes = [
        u64, ctypes.POINTER(u64), ctypes.POINTER(u64), ctypes.POINTER(u64)]
    lib.brpc_tpu_ici_respond_batch.restype = ctypes.c_int
    lib.brpc_tpu_ici_respond_batch.argtypes = [ctypes.POINTER(IciRespC), u64]
    lib.brpc_tpu_ici_echo_p50_ns.restype = ctypes.c_int64
    lib.brpc_tpu_ici_echo_p50_ns.argtypes = [
        ctypes.c_int, ctypes.c_int, u64, u64, ctypes.c_int32]
    lib.brpc_tpu_ici_codec_pack.restype = u64
    lib.brpc_tpu_ici_codec_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, u64, u64, u64, u64,
        ctypes.c_char_p, u64, u64, ctypes.c_char_p, u64, u64,
        ctypes.c_char_p, u64, ctypes.POINTER(ctypes.c_void_p)]
    lib.brpc_tpu_ici_codec_unpack.restype = ctypes.c_int
    lib.brpc_tpu_ici_codec_unpack.argtypes = [
        ctypes.c_char_p, u64, ctypes.POINTER(u64),
        ctypes.POINTER(ctypes.c_void_p)]
    _bind_tcp(lib)
    return lib


def _bind_tcp(lib: ctypes.CDLL) -> None:
    """The TCP datapath of ``csrc/rpc_native.cpp``: the same signatures as
    the reference core's."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64, i64, cint, cstr = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_char_p)
    u8pp, u64p = ctypes.POINTER(u8p), ctypes.POINTER(u64)
    call_args = [u64, cstr, u8p, u64, u8p, u64, i64, u8pp, u64p, u8pp,
                 u64p, ctypes.POINTER(cstr)]
    sigs = {
        "nserver_start": (u64, [cint]),
        "nserver_port": (cint, [u64]),
        "nserver_register_echo": (cint, [u64, cstr]),
        "nserver_set_handler": (cint, [u64, _NREQ_FN]),
        "nserver_requests": (u64, [u64]),
        "nserver_respond": (cint, [u64, u64, cstr, u8p, u64, u8p, u64]),
        "nserver_stop": (None, [u64]),
        "nchannel_connect": (u64, [cstr, cint]),
        "nchannel_call": (u64, call_args),
        "nchannel_close": (None, [u64]),
        "nchannel_call_async": (u64, [u64, cstr, u8p, u64, u8p, u64, i64,
                                      _ASYNC_CB, ctypes.c_void_p]),
        "npool_connect": (u64, [cstr, cint, cint]),
        "npool_call": (u64, call_args),
        "npool_close": (None, [u64]),
        "native_echo_p50_ns": (i64, [cint, cint]),
        "native_rpc_echo_p50_ns": (i64, [cint, cint]),
        "native_rpc_qps": (ctypes.c_double, [cint, cint, cint]),
        "native_rpc_throughput_gbps": (ctypes.c_double, [cint, cint, cint]),
        "native_async_throughput_gbps": (ctypes.c_double,
                                         [cint, cint, cint]),
        "native_pooled_throughput_gbps": (ctypes.c_double,
                                          [cint, cint, cint, cint]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, "brpc_tpu_" + name)
        fn.restype = restype
        fn.argtypes = argtypes


# ---- the TCP datapath's bench entries (bench.py's native legs) ----------

def native_echo_p50_us(iters: int = 2000, payload: int = 4096) -> float:
    """Raw epoll TCP echo round-trip p50 (µs): bytes in, the same bytes
    out, no framing; -1 if unavailable."""
    lib = load()
    if lib is None:
        return -1.0
    ns = lib.brpc_tpu_native_echo_p50_ns(iters, payload)
    return ns / 1000.0 if ns > 0 else -1.0


def native_rpc_echo_p50_us(iters: int = 3000, payload: int = 4096) -> float:
    """Full native RPC stack echo p50 (µs): channel → TRPC frame → epoll
    server → dispatch → response → correlation wake, all in
    ``csrc/rpc_native.cpp``.  -1 if unavailable."""
    lib = load()
    if lib is None:
        return -1.0
    ns = lib.brpc_tpu_native_rpc_echo_p50_ns(iters, payload)
    return ns / 1000.0 if ns > 0 else -1.0


def native_rpc_qps(threads: int = 16, duration_ms: int = 1500,
                   payload: int = 128) -> float:
    """Multi-threaded native RPC echo QPS; -1 if unavailable."""
    lib = load()
    if lib is None:
        return -1.0
    return lib.brpc_tpu_native_rpc_qps(threads, duration_ms, payload)


def native_rpc_throughput_gbps(threads: int = 2, duration_ms: int = 1500,
                               payload: int = 4 << 20) -> float:
    """Large-request echo throughput GB/s (request bytes), ``threads``
    callers on a connection each to one server; -1 if unavailable."""
    lib = load()
    if lib is None:
        return -1.0
    return lib.brpc_tpu_native_rpc_throughput_gbps(threads, duration_ms,
                                                   payload)


def native_pooled_throughput_gbps(nconns: int = 2, threads: int = 2,
                                  duration_ms: int = 1500,
                                  payload: int = 1 << 20) -> float:
    """``threads`` callers sharing one pool of ``nconns`` connections
    (round-robin per call); GB/s, -1 if unavailable."""
    lib = load()
    if lib is None:
        return -1.0
    return lib.brpc_tpu_native_pooled_throughput_gbps(
        nconns, threads, duration_ms, payload)


def native_async_throughput_gbps(depth: int = 4, duration_ms: int = 1500,
                                 payload: int = 256 << 10) -> float:
    """Pipelined throughput on one connection, ``depth`` async calls in
    flight; GB/s, -1 if unavailable."""
    lib = load()
    if lib is None:
        return -1.0
    return lib.brpc_tpu_native_async_throughput_gbps(depth, duration_ms,
                                                     payload)


_fab_lib: Optional[ctypes.CDLL] = None
_fab_error = ""


def load_fabric() -> Optional[ctypes.CDLL]:
    """The bound bulk-and-shm library, built on first use; None when it
    cannot be built or loaded (``fabric_load_error()`` says why)."""
    global _fab_lib, _fab_error
    lib = _fab_lib
    if lib is not None:
        return lib
    with _lib_lock:
        if _fab_lib is not None:
            return _fab_lib
        try:
            _fab_lib = _bind_fabric(ctypes.CDLL(
                str(build("fabric_native", FABRIC_SOURCES))))
        except Exception as e:
            _fab_error = f"{type(e).__name__}: {e}"
            return None
        return _fab_lib


def fabric_load_error() -> str:
    return _fab_error


def _bind_fabric(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64, i64, i32, u32 = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32,
                          ctypes.c_uint32)
    cint, cstr = ctypes.c_int, ctypes.c_char_p
    vpp, u64p = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(u64)
    sigs = {
        # the bulk conn: uuid-tagged frames over one connection per pair
        "fab_listen": (u64, [cstr, ctypes.POINTER(cint), cstr, cint]),
        "fab_connect_uds": (u64, [cstr, cstr]),
        "fab_accept": (u64, [u64, cstr, i64]),
        "fab_connect": (u64, [cstr, cint, cstr]),
        "fab_send": (cint, [u64, u64, u8p, u64]),
        "fab_sendv": (cint, [u64, u64, vpp, u64p, cint]),
        "fab_recv": (cint, [u64, u64, i64, ctypes.POINTER(u8p), u64p]),
        "fab_bytes": (u64, [u64, cint]),
        "fab_buf_release": (None, [u64, u8p, u64]),
        "fab_conn_close": (None, [u64]),
        "fab_listener_close": (None, [u64]),
        "fab_alive": (cint, [u64]),
        "fab_chaos": (cint, [u64, cint, i64]),
        "fab_chaos_listener": (cint, [u64, i64]),
        "fab_quiesce": (None, []),
        "fab_set_peer": (None, [u64, i32]),
        "fab_pair_stats": (cint, [i32, u64p, u64p, u64p]),
        "fab_peer_list": (cint, [ctypes.POINTER(i32), cint]),
        # the shm ring: one mmap'd segment per pair, futex doorbells,
        # zero-copy claims retired on release
        "shm_create": (u64, [cstr, u64]),
        "shm_create2": (u64, [cstr, u64, u32]),
        "shm_attach": (u64, [cstr]),
        "shm_unlink": (cint, [cstr]),
        "shm_send": (cint, [u64, u64, u8p, u64, i64]),
        "shm_sendv": (cint, [u64, u64, vpp, u64p, cint, i64]),
        "shm_send2": (cint, [u64, u32, u64, u8p, u64, i64]),
        "shm_sendv2": (cint, [u64, u32, u64, vpp, u64p, cint, i64]),
        "shm_recv": (cint, [u64, u64, i64, ctypes.POINTER(u8p), u64p]),
        "shm_recv2": (cint, [u64, u32, u64, i64, ctypes.POINTER(u8p),
                             u64p]),
        "shm_release": (None, [u64, u8p, u64]),
        "shm_alive": (cint, [u64]),
        "shm_mark_dead": (None, [u64]),
        "shm_close": (None, [u64]),
        "shm_chaos": (cint, [u64, cint, i64]),
        "shm_stats": (cint, [u64, u64p, cint]),
        "shm_stripes": (u32, [u64]),
        "shm_stripe_stats": (cint, [u64, u32, u64p, cint]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, "brpc_tpu_torch_" + name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
