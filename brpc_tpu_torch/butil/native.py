"""ctypes loader and ABI of the port's native ici:// core.

The core is ``csrc/ici_native.cpp`` (with ``flat_map.h`` and
``tsan_compat.h`` beside it): host C++, not a kernel.  At first use
``g++ -O2 -fPIC -shared -pthread`` builds it into ``_build/`` beside the
package, named by a digest of the three sources and the flags, so an edit
to any of them builds a fresh library instead of loading a stale one.
Concurrent first uses (test workers, several processes) agree through a
file lock: one builds to a temporary name and renames it into place, the
others wait and load the result.  Nothing is built or loaded when a module
is imported.

The library is built with hidden visibility and ``-Bsymbolic``: its
listener registry and every internal symbol are its own, even in a
process that has loaded another copy of the same datapath.

Only the ici plane's symbols and ``brpc_tpu_buf_free`` are bound.
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
SOURCES = ("ici_native.cpp", "flat_map.h", "tsan_compat.h")
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


def source_digest() -> str:
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libici_native-{source_digest()}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++); set CXX")
    return cxx


def build() -> Path:
    """Build the core when no library of these sources exists; returns its
    path.  Raises with the compiler's output on failure."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "ici_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():          # another process built it
                return lib_path
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_compiler(), *CXX_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / "ici_native.cpp")]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"ici_native: build failed "
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
    return lib
