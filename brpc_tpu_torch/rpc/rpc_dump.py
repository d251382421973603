"""rpc_dump: sampled capture of inbound requests, for replay.

Reference: src/brpc/rpc_dump.{h,cpp}, ported from
:mod:`brpc_tpu.rpc.rpc_dump`.  With ``rpc_dump`` on, tpu_std hands every
request it receives to :func:`maybe_dump_request`; a sampled subset (at
most 100 a second, through the bvar collector's speed limit) is appended
to size-capped files ``requests.NNNNNN`` under ``rpc_dump_dir``, rotated
after ``rpc_dump_max_requests_in_one_file`` requests, keeping the newest
``rpc_dump_max_files``; a change of ``rpc_dump_dir`` starts a new file
there.  A record is the tpu_std frame itself (magic,
meta, payload and attachment), so a dump file is a byte stream a socket
could replay (:mod:`..tools.rpc_replay`); the files equal the JAX
package's byte for byte.

A DEVICE block of the frame is read to the host for the file.  The
transport commits a received frame only after its device copy completed,
and the read is ordered after the plane's copies on the device as well
(:meth:`DevicePlane.order_after_copies`): the buffer is never read blind.

The fabric's plane-frame trace: with ``rpc_dump`` on, every bulk-conn
and shm-ring healing frame (types 8-11 and 17-20) a fabric socket sends
or receives is appended to ``fabric_planes.trace`` under
``rpc_dump_dir``, one JSON line ``{"sock", "dir", "ftype", "body"}`` a
frame (the body in hex), as the JAX package writes it
(:func:`maybe_dump_fabric_frame`, :func:`load_fabric_trace`).  The fabric
filters to those types, so a healthy call writes nothing.
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

from .. import bvar
from ..butil import flags as _flags
from ..butil.iobuf import DEVICE, IOBuf

_flags.define_flag("rpc_dump", False, "capture sampled requests to disk")
_flags.define_flag("rpc_dump_dir", "./rpc_dump", "dump output directory")
_flags.define_flag("rpc_dump_max_files", 4, "rotated dump files kept",
                   _flags.positive_integer)
_flags.define_flag("rpc_dump_max_requests_in_one_file", 1000,
                   "requests per file before rotation",
                   _flags.positive_integer)

# the Flag object: tpu_std reads it with one attribute load a request
dump_flag = _flags.flag_object("rpc_dump")

_speed_limit = bvar.CollectorSpeedLimit(max_samples_per_second=100)
_lock = threading.Lock()
_current_file = None
_current_dir = ""
_current_count = 0
_file_index = 0
dumped_count = bvar.Adder("rpc_dump_count")


def dump_enabled() -> bool:
    return bool(dump_flag.value)


def maybe_dump_request(frame: IOBuf) -> bool:
    """Called by the protocol with a request's whole wire frame; True when
    the frame was written."""
    global _current_count
    if not dump_enabled() or not _speed_limit.is_sampled():
        return False
    data = _frame_bytes(frame)
    with _lock:
        if (_current_file is None or _current_count >= _flags.get_flag(
                "rpc_dump_max_requests_in_one_file")
                or _current_dir != _flags.get_flag("rpc_dump_dir")):
            _rotate_locked()
        try:
            _current_file.write(data)
            _current_file.flush()
            _current_count += 1
        except OSError:
            return False
    dumped_count << 1
    return True


def _frame_bytes(frame: IOBuf) -> bytes:
    """The frame's bytes, a DEVICE block's read to the host after the
    plane's copies on its device."""
    devices = set()
    for i in range(frame.backing_block_num()):
        blk = frame.backing_block(i).block
        if blk.kind == DEVICE and blk.data.is_cuda:
            devices.add(blk.data.device)
    if devices:
        from ..ici.device_plane import DevicePlane
        plane = DevicePlane._instance
        if plane is not None:
            for dev in devices:
                plane.order_after_copies(dev)
    return frame.to_bytes()


def _rotate_locked() -> None:
    global _current_file, _current_dir, _current_count, _file_index
    d = _current_dir = _flags.get_flag("rpc_dump_dir")
    os.makedirs(d, exist_ok=True)
    if _current_file is not None:
        _current_file.close()
    path = os.path.join(d, f"requests.{_file_index:06d}")
    _current_file = open(path, "wb")
    _current_count = 0
    _file_index += 1
    keep = _flags.get_flag("rpc_dump_max_files")
    files = sorted(f for f in os.listdir(d) if f.startswith("requests."))
    for old in files[:-keep] if len(files) > keep else []:
        try:
            os.unlink(os.path.join(d, old))
        except OSError:
            pass


def list_dump_files(directory: Optional[str] = None) -> List[str]:
    d = directory or _flags.get_flag("rpc_dump_dir")
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.startswith("requests."))


def load_dumped_frames(path: str) -> List[bytes]:
    """Split a dump file back into frames, by their headers' sizes."""
    from ..policy.tpu_std import HEADER_SIZE, MAGIC
    frames = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + HEADER_SIZE <= len(data):
        if data[pos:pos + 4] != MAGIC:
            break
        meta_size = int.from_bytes(data[pos + 4:pos + 8], "big")
        body_size = int.from_bytes(data[pos + 8:pos + 12], "big")
        end = pos + HEADER_SIZE + meta_size + body_size
        if end > len(data):
            break
        frames.append(data[pos:end])
        pos = end
    return frames


# ---- the fabric's plane-frame trace ------------------------------------

_FABRIC_TRACE_NAME = "fabric_planes.trace"
_fab_trace_lock = threading.Lock()


def maybe_dump_fabric_frame(sock, direction: str, ftype: int,
                            body: bytes) -> bool:
    """Append one plane-healing control frame to the trace: the socket's
    id, the direction ("in" or "out"), the frame type and the body in
    hex."""
    if not dump_enabled():
        return False
    rec = json.dumps({"sock": getattr(sock, "id", 0),
                      "dir": direction, "ftype": ftype,
                      "body": bytes(body).hex()})
    d = _flags.get_flag("rpc_dump_dir")
    with _fab_trace_lock:
        try:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, _FABRIC_TRACE_NAME), "a") as f:
                f.write(rec + "\n")
        except OSError:
            return False
    return True


def load_fabric_trace(directory: Optional[str] = None) -> List[dict]:
    """The plane-frame trace as dicts in the order written (empty when
    none was recorded)."""
    d = directory or _flags.get_flag("rpc_dump_dir")
    path = os.path.join(d, _FABRIC_TRACE_NAME)
    if not os.path.isfile(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
