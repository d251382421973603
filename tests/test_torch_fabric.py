"""The multi-process ici:// fabric on both packages (``brpc_tpu.ici.fabric``
and ``brpc_tpu_torch.ici.fabric``).

In process, over socket pairs, each package's FabricSocket built on a stub
node: the control frames' bytes, the DATA frame's kind-0 and kind-4
descriptor bytes for the same frame, ``CollectiveSequencer``'s slots for
the same interleaving of submits, and the codes a peer's death and a
GOODBYE give calls in flight — all equal.

Across processes (fresh interpreters, the store on ``127.0.0.1:0``), the
port alone: ``chip_smoke.py`` phase 17 at a small size on the CPU (its
overload leg, whose p99s read the card's host, left out), whose
device leg is the plain version (the row in a shared-memory segment,
``p2p_copy_plain`` reading it): echo bytes, plain launches = transfers
received = attachments received in both processes, zero transfers active
after a kill and a stop, no segment of the run's processes left, revival
of a restarted peer, GOODBYE, and its leg (f), a peer whose open of the
device leg refuses; and the same forced failure alone, failing the call
with EINTERNAL and no host route.  Children load no JAX and nothing of
the JAX package (``tests/test_fabric.py:188-260``'s pattern).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu.bthread import id as jid
from brpc_tpu.butil.iobuf import IOBuf as JBuf, IOPortal as JPortal
from brpc_tpu.ici import device_plane as jdp
from brpc_tpu.ici import fabric as jfab
from brpc_tpu.rpc import errors as jerrors
from brpc_tpu.rpc import lameduck as jlameduck
from brpc_tpu.rpc.input_messenger import InputMessenger as JMessenger
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch.bthread import id as tid
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf, IOPortal as TPortal
from brpc_tpu_torch.ici import device_plane as tdp
from brpc_tpu_torch.ici import fabric as tfab
from brpc_tpu_torch.ici import ipc_pull as tipc
from brpc_tpu_torch.ici import plane_health as tph
from brpc_tpu_torch.ici.mesh import IciMesh as TMesh
from brpc_tpu_torch.rpc import errors as terrors
from brpc_tpu_torch.rpc import lameduck as tlameduck
from brpc_tpu_torch.rpc.input_messenger import InputMessenger as TMessenger

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UUID = (1 << 40) | 7          # process 0's seventh uuid


class _JNode:
    """The JAX FabricSocket's view of its node: no transfer server, no
    shm, a peer that advertised the sequenced device plane."""
    _xfer_server = None
    process_id = 0

    def peer_info(self, pid, timeout_ms=60000):
        return {"dplane3": 3}

    def shm_peer_ok(self, pid):
        return False

    def next_uuid(self):
        return UUID


class _TNode:
    """The port FabricSocket's view of its node."""

    def __init__(self):
        self.mesh = TMesh(ranks=8, device="cpu")
        self._health = tph.register_plane(
            "device", threading.Lock(), retry_s=lambda: 2.0)

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


JAX = types.SimpleNamespace(name="jax", fab=jfab, dp=jdp, ids=jid,
                            errors=jerrors, Messenger=JMessenger,
                            node=_JNode, Buf=JBuf, Portal=JPortal,
                            lameduck=jlameduck)
PORT = types.SimpleNamespace(name="port", fab=tfab, dp=tdp, ids=tid,
                             errors=terrors, Messenger=TMessenger,
                             node=_TNode, Buf=TBuf, Portal=TPortal,
                             lameduck=tlameduck)


def _sock(pkg, conn, node=None, **kw):
    s = pkg.fab.FabricSocket(conn, local_dev=kw.pop("local_dev", 0),
                             remote_dev=kw.pop("remote_dev", 5),
                             peer_pid=1, node=node or pkg.node(), **kw)
    # server side: the sequencer's master, and no health check is started
    # for a socket that dies
    s.is_server_side = True
    return s


def _read_frames(conn, timeout=5.0):
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
    frames = []
    off = 0
    while off + 5 <= len(data):
        ftype, n = struct.unpack_from("<BI", data, off)
        frames.append((ftype, data[off + 5:off + 5 + n]))
        off += 5 + n
    return frames


def _transfer(pkg, uuid, mesh=None):
    if pkg is JAX:
        return jdp.DeviceTransfer(uuid, 0, 1, 8)
    return tdp.DeviceTransfer(uuid, 0, 1, 8, None, mesh)


def _control_frames(pkg):
    a, b = socket.socketpair()
    node = pkg.node()
    s = _sock(pkg, a, node=node, window_bytes=64)
    ran = []
    if pkg is JAX:
        s._dplane_execute_bulk = lambda t: ran.append(t.uuid)
    else:
        s._dplane_execute = lambda t: ran.append(t.uuid)
    s.send_goodbye()
    # a read consumes past the batching mark: one CREDIT
    with s._inbox_lock:
        s._inbox.append(b"z" * 100)
    s._do_read(pkg.Portal(), 100)
    # the master assigns a peer's unassigned send and says so
    seqr = s._dplane_sequencer()
    seqr.submit_remote(_transfer(pkg, 0xABC, getattr(node, "mesh", None)),
                       -1)
    deadline = time.monotonic() + 5
    while not ran and time.monotonic() < deadline:
        time.sleep(0.01)
    # a lame-duck hard stop: FIN carries ELOGOFF
    s.set_failed(pkg.errors.ELOGOFF, "server stopping")
    frames = _read_frames(b)
    b.close()
    for ft, body in ((pkg.fab._F_PING, struct.pack("<I", 3)),
                     (pkg.fab._F_PING_OK, b""), (pkg.fab._F_PING_ERR, b""),
                     (pkg.fab._F_HELLO_ERR, b"no server at ici://3")):
        x, y = socket.socketpair()
        pkg.fab._send_frame(x, ft, body)
        x.close()
        frames += _read_frames(y)
        y.close()
    return frames, ran


def test_control_frames_equal_jax():
    jframes, jran = _control_frames(JAX)
    tframes, tran = _control_frames(PORT)
    assert tframes == jframes
    assert [f[0] for f in tframes] == [15, 5, 16, 7, 12, 13, 14, 3]
    assert tframes[2][1] == struct.pack("<Qq", 0xABC, 0)
    assert tframes[3][1] == struct.pack("<I", terrors.ELOGOFF)
    assert jran == tran == [0xABC]


@pytest.fixture
def host_plane():
    saved = {k: tflags.get_flag(k) for k in (
        "ici_device_plane_host_mesh", "ici_device_plane_threshold")}
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 4096)
    yield
    for k, v in saved.items():
        tflags.set_flag(k, v)


def test_data_frame_descriptors_equal_jax(monkeypatch, host_plane):
    """One frame — host bytes, an 8 KiB DEVICE payload owned by rank 1,
    host bytes, a 100 B DEVICE payload — encodes to the same bytes: a
    kind-0 chunk, the kind-4 descriptor (uuid, dtype, shape, length, src,
    seq, trace), and one kind-0 chunk holding the tail host bytes and the
    small payload's bytes.  The port's export, which rides after the
    descriptor for port peers only, is left empty here."""
    import jax
    import numpy as np
    big = (np.arange(8192) % 251).astype(np.uint8)
    small = (np.arange(100) * 3 % 256).astype(np.uint8)
    # the JAX side
    a, _b = socket.socketpair()
    js = _sock(JAX, a)
    js._dplane_usable = lambda n: n >= 4096
    js._dplane_execute_bulk = lambda t: None
    monkeypatch.setattr(
        jdp.plane(), "post_send",
        lambda arr, src, dst, socket=None, uuid=None, remote=False:
        jdp.DeviceTransfer(uuid, src, dst, int(arr.shape[0]), src_arr=arr))
    devs = jax.devices()
    jframe = JBuf(b"0123456789")
    jframe.append_device_array(jax.device_put(big, devs[1]))
    jframe.append(b"abcdefg")
    jframe.append_device_array(jax.device_put(small, devs[2]))
    jbody = js._encode_data(jframe)
    js._close_dplane()
    # the port side
    a2, _b2 = socket.socketpair()
    ts = _sock(PORT, a2)
    ts._dplane_execute = lambda t: None
    monkeypatch.setattr(tipc, "export_row", lambda arr: tipc.Export(b""))
    mesh = ts.mesh
    tframe = TBuf(b"0123456789")
    tframe.append_device_array(mesh.device_put(torch.from_numpy(big), 1))
    tframe.append(b"abcdefg")
    tframe.append_device_array(mesh.device_put(torch.from_numpy(small), 2))
    tbody = ts._encode_data(tframe)
    assert ts.inflight_send_blocks() == 1
    ts._flush_staged()
    ts._close_dplane()
    assert tbody == jbody
    want = (struct.pack("<I", 3) + struct.pack("<BI", 0, 10) + b"0123456789"
            + tfab.encode_device_descriptor(UUID, 8192, 1, 0)
            + struct.pack("<BI", 0, 107) + b"abcdefg" + small.tobytes())
    assert tbody == want
    for s in (js, ts):
        s.set_failed(terrors.ECLOSE, "test done")


def test_write_on_an_ended_connection_fails_as_a_dead_socket(
        monkeypatch, host_plane):
    """A DEVICE payload written while the connection ends (its sequencer
    already closed by the EOF) fails the write as a dead connection,
    EFAILEDSOCKET, which a channel retries, not EINTERNAL, the device
    leg's refusal, which it does not; the payload is unstaged and its
    transfer fails, and no byte of it goes out another way."""
    from brpc_tpu_torch.rpc.controller import Controller
    a, b = socket.socketpair()
    ts = _sock(PORT, a)
    ts._dplane_execute = lambda t: None
    monkeypatch.setattr(tipc, "export_row", lambda arr: tipc.Export(b""))
    frame = TBuf(b"head")
    frame.append_device_array(ts.mesh.device_put(
        torch.arange(8192, dtype=torch.int32).to(torch.uint8), 1))
    ts._close_dplane()                   # as _on_connection_over does
    active = tdp.plane().active_transfers()
    with pytest.raises(ConnectionError) as info:
        ts._encode_data(frame)
    code = getattr(info.value, "error_code", terrors.EFAILEDSOCKET)
    assert code == terrors.EFAILEDSOCKET
    assert Controller._retryable(code)
    assert ts.inflight_send_blocks() == 0
    assert tdp.plane().active_transfers() == active
    ts.set_failed(code, str(info.value))
    a.close()
    assert [f for f in _read_frames(b, 1.0) if f[0] == tfab._F_DATA] == []
    b.close()


def _sequence(pkg, master: bool, ops):
    mesh = TMesh(ranks=8, device="cpu") if pkg is PORT else None
    sent = []
    ran = []
    sock = types.SimpleNamespace(
        failed=False, remote_dev=1, _peer_gone=lambda: False,
        _ctrl_send=lambda ft, body: sent.append((ft, body)),
        _device_plane_down=lambda reason: None)
    if pkg is JAX:
        sock._dplane_execute_bulk = lambda t: ran.append(t.uuid)
    else:
        sock._dplane_execute = lambda t: ran.append(t.uuid)
    seqr = pkg.fab.CollectiveSequencer(sock, master=master)
    seqs = []
    for op in ops:
        if op[0] == "local":
            seqs.append(seqr.submit_local(_transfer(pkg, op[1], mesh)))
        elif op[0] == "remote":
            seqr.submit_remote(_transfer(pkg, op[1], mesh), op[2])
        else:
            seqr.on_assignment(op[1], op[2])
    n = sum(1 for op in ops if op[0] in ("local", "remote"))
    deadline = time.monotonic() + 5
    while len(ran) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    desc = seqr.describe()
    seqr.close()
    return seqs, sent, ran, desc


@pytest.mark.parametrize("master,ops", [
    (True, [("local", 1), ("remote", 2, -1), ("local", 3),
            ("remote", 4, -1), ("remote", 5, -1), ("local", 6)]),
    (False, [("local", 11), ("remote", 12, 0), ("assign", 11, 1),
             ("local", 13), ("remote", 14, 3), ("assign", 13, 2),
             ("remote", 15, 4)]),
], ids=["master", "client"])
def test_sequencer_slots_equal_jax(master, ops):
    jres = _sequence(JAX, master, ops)
    tres = _sequence(PORT, master, ops)
    assert tres == jres
    seqs, sent, ran, desc = tres
    assert desc["executed"] == len(ran) == 6 - (not master)


def _codes(pkg, goodbye: bool):
    """A socket with one call in flight; its peer either vanishes (a
    SIGKILL: no FIN) or sends GOODBYE and a lame-duck FIN.  Returns the
    call's code and whether the socket went logoff."""
    a, b = socket.socketpair()
    s = _sock(pkg, a)
    s.messenger = pkg.Messenger(server=None)
    got = []
    done = threading.Event()

    def on_error(data, cid, code):
        got.append(code)
        pkg.ids.unlock_and_destroy(cid)
        done.set()

    cid = pkg.ids.create_ranged(None, on_error, 1)
    s._inflight_cids.add(cid)
    s.start_io()
    if goodbye:
        pkg.fab._send_frame(b, pkg.fab._F_GOODBYE, b"")
        time.sleep(0.05)
        pkg.fab._send_frame(b, pkg.fab._F_FIN,
                            struct.pack("<I", pkg.errors.ELOGOFF))
    b.close()
    assert done.wait(5)
    # the GOODBYE marked the peer draining in this process: undo it for
    # the tests that follow in this worker
    pkg.lameduck.clear_peer_draining(s.remote_side)
    return got[0], s.logoff


def test_peer_death_and_goodbye_codes_equal_jax():
    assert _codes(PORT, False) == _codes(JAX, False) == (terrors.EEOF,
                                                          False)
    assert _codes(PORT, True) == _codes(JAX, True) == (terrors.ELOGOFF,
                                                        True)


def test_kill_code_in_chip_smoke_is_jax_code():
    import chip_smoke
    assert chip_smoke.FABRIC_KILL_CODE == jerrors.EEOF == terrors.EEOF


# ---- two processes ---------------------------------------------------------

_PHASE17_CPU = r"""
import importlib, json, os, sys
sys.path.insert(0, %(repo)r)
import torch
import chip_smoke as cs
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import device_plane, ipc_pull
from brpc_tpu_torch.ici.mesh import IciMesh
cm = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
plain = [0]
inner = cm.p2p_copy_plain
def counted(src, dst):
    plain[0] += 1
    return inner(src, dst)
cm.p2p_copy_plain = counted
flags.set_flag("ici_device_plane_host_mesh", True)
mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
cs.FABRIC_BIG = 256 << 10
cs.FABRIC_SMALL_CALLS, cs.FABRIC_BIG_CALLS, cs.FABRIC_TCP_CALLS = 40, 8, 40
cs.FABRIC_STREAM_S = 0.3
out = cs.phase_fabric(mesh, device_plane.plane(), cm.p2p_copy,
                      device="cpu", launches=lambda: plain[0],
                      overload=False)
out["segments_left"] = [n for pid in [os.getpid(), *out["pids"]]
                        for n in ipc_pull.segments_on_disk(pid)]
out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                        or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
print("RESULT " + json.dumps(out), flush=True)
"""


def _run_child(script, timeout=120):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", script], cwd=_REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def test_two_process_fabric_on_the_plain_leg():
    out = _run_child(_PHASE17_CPU % {"repo": _REPO})
    echo = out["echo"]
    calls = 40 + 8
    for side in (echo["this_process"], echo["peer"]):
        assert side["launches"] == side["received"] == \
            side["attachments"] == calls
    assert out["launches"] == out["received"] > calls
    assert out["tcp"]["internal_port_code"] == terrors.EEOF
    assert out["tcp"]["stream_bytes"] > 0
    assert out["kill"]["codes"] == [terrors.EEOF] * 8
    assert out["stop"]["codes"] == [0] * 8 and out["stop"]["goodbye"]
    final = out["stop"]["peer_final"]
    assert final["active"] == final["mapped"] == final["segments"] == 0
    assert out["segments_left"] == []
    forced = out["forced"]
    assert forced["first"][0] == terrors.EINTERNAL
    assert "forced" in forced["first"][1]
    assert forced["latched"][0] == terrors.EINTERNAL
    assert forced["peer"]["attachments"] == forced["peer"]["launches"] == 0
    assert forced["inline_bytes"] < 256 << 10
    assert out["foreign"] == []
    assert final["foreign"] == []


_FORCED_OPEN_FAILURE = r"""
import json, os, subprocess, sys, time
sys.path.insert(0, %(repo)r)
from datetime import timedelta
import torch
import brpc_tpu_torch.policy
from torch.distributed import TCPStore
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.ici import fabric, ipc_pull
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.tools.fabric_peer import DEVICE_THRESHOLD
from chip_smoke import _REFUSING_PEER

flags.set_flag("ici_device_plane_host_mesh", True)
flags.set_flag("ici_device_plane_threshold", DEVICE_THRESHOLD)
mesh = IciMesh(ranks=8, device="cpu")
IciMesh.set_default(mesh)
import socket
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
coord = f"127.0.0.1:{port}"
node = fabric.FabricNode.initialize(coord, 2, 0, ranks=range(4, 8))
kv = TCPStore("127.0.0.1", port, is_master=False,
              timeout=timedelta(seconds=60))
peer = subprocess.Popen([sys.executable, "-c", _REFUSING_PEER, coord, "x",
                         "--device", "cpu"], cwd=%(repo)r,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)
kv.wait(["fabric_peer/x"], timedelta(seconds=60))
ch = rpc.Channel()
ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=10000,
                                              max_retry=0))
def push(att):
    cntl = rpc.Controller()
    if att is not None:
        cntl.request_attachment.append_device_array(att)
    resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="x"),
                          EchoResponse)
    return cntl, resp
row = mesh.device_put(torch.arange(65536).to(torch.uint8), 4)
first, _ = push(row)
latched, _ = push(row)
stats_cntl = rpc.Controller()
resp = ch.call_method("Sink.Stats", stats_cntl, EchoRequest(message=""),
                      EchoResponse)
stats = json.loads(resp.message) if not stats_cntl.failed() else None
ch.close()
peer.kill()
peer.wait()
print("RESULT " + json.dumps({
    "first": [first.error_code, first.error_text],
    "latched": [latched.error_code, latched.error_text],
    "peer": stats,
    "segments": ipc_pull.segments_on_disk(os.getpid())
    + (ipc_pull.segments_on_disk(stats["os_pid"]) if stats else []),
    "routes": __import__("brpc_tpu_torch.ici.route",
                         fromlist=["x"]).route_stats()}), flush=True)
node.quiesce()
"""


def test_failed_ipc_open_fails_the_call_with_its_code():
    """The receiver's open of the device leg fails (a fake): the call
    fails EINTERNAL with the reason, the next DEVICE payload to that peer
    fails at once on the latched plane, and neither crossed another way:
    the peer's handler saw no attachment and launched no copy."""
    out = _run_child(_FORCED_OPEN_FAILURE % {"repo": _REPO})
    code, text = out["first"]
    assert code == terrors.EINTERNAL and "forced" in text, out
    code, text = out["latched"]
    assert code == terrors.EINTERNAL and "down" in text, out
    assert out["peer"]["attachments"] == 0
    assert out["peer"]["launches"] == out["peer"]["received"] == 0
    assert out["segments"] == []
    # the refused payload was never sent inline: only the two small
    # Stats/Push frames' host bytes rode kind 0
    assert out["routes"].get("inline_bytes", 0) < 65536
