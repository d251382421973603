"""The public names the surface census (``tests/test_torch_surface.py``)
brought into the port, each run through both packages on the same
inputs and the outcomes compared: the IOBuf's ``copy_to``,
``copy_to_file_descriptor`` (through a pipe), ``push_back``,
``append_device_array_unchecked`` and ``Block.cap``;
``hostname2endpoint``; the logging calls ``log``, ``fatal``,
``log_every_n``, ``set_min_log_level`` and ``vlog_is_on``;
``register_compression``; ``Controller.handle_parsed_http_response``
(an HTTP client call's parsed response) and ``Controller.local_side``
(an in-process call's address); ``DevicePlane.transfer_local``,
``DevicePlane.mesh`` and ``mesh_index_of`` on a CPU mesh of 8 ranks;
``CollectiveRegistry.serving``; ``InputMessenger.protocols``;
``Flag.reloadable``; ``Pb2JsonOptions`` with ``pb_to_json`` and
``pb_to_dict``; the names the port's ``__init__`` files bind now, each
reached through its package as a caller writes it: ``rpc.probe_endpoint``,
``rpc.HealthCheckTask`` and ``rpc.start_health_check`` (the backoff, the
application probe, the probe budget and the revival keys) and
``ici.ici_transport_stats`` (an ``ici://`` echo's device bytes).

Each case returns what a caller sees, built from plain values; the
port's must equal the JAX package's.  A case's tensor or array inputs
come from one numpy seed.
"""
from __future__ import annotations

import logging as pylog
import os
import time

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import endpoint as jendpoint
from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil import iobuf as jiobuf
from brpc_tpu.butil import logging as jlog
from brpc_tpu.channels import collective_fanout as jfanout
from brpc_tpu.codec import json2pb as jjson
from brpc_tpu.ici import device_plane as jdp
from brpc_tpu.ici.mesh import IciMesh as JaxMesh
from brpc_tpu.proto import trackme_pb2 as jtrack
from brpc_tpu.rpc import compress as jcompress
from brpc_tpu.rpc import input_messenger as jmessenger
from brpc_tpu.rpc import protocol as jprotocol
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch.butil import endpoint as tendpoint
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil import iobuf as tiobuf
from brpc_tpu_torch.butil import logging as tlog
from brpc_tpu_torch.channels import collective_fanout as tfanout
from brpc_tpu_torch.codec import json2pb as tjson
from brpc_tpu_torch.ici import device_plane as tdp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto import echo_pb2 as tpb
from brpc_tpu_torch.proto import trackme_pb2 as ttrack
from brpc_tpu_torch.rpc import compress as tcompress
from brpc_tpu_torch.rpc import input_messenger as tmessenger
from brpc_tpu_torch.rpc import protocol as tprotocol
from tests import echo_pb2 as jpb
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

PKGS = ["jax", "port"]


def _seeded(n, seed=24):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.fixture(autouse=True)
def cpu_mesh():
    """The port's default mesh is 8 CPU ranks (the JAX package's CPU
    platform has 8 devices), put back after the test."""
    before = IciMesh._default
    IciMesh.set_default(IciMesh(8, device="cpu"))
    yield
    IciMesh.set_default(before)


# ---- butil ----------------------------------------------------------------

def _iobuf_copy_to(name):
    iobuf = jiobuf if name == "jax" else tiobuf
    data = _seeded(3000).tobytes()
    buf = iobuf.IOBuf()
    buf.append(data[:1000])
    buf.append(data[1000:])
    for b in (0, 7, 255):
        buf.push_back(b)
    return {"all": buf.copy_to(), "head": buf.copy_to(10),
            "mid": buf.copy_to(10, pos=995), "tail": buf.copy_to(pos=2998),
            "past": buf.copy_to(5, pos=4000), "size_after": len(buf)}


def _iobuf_copy_to_file_descriptor(name):
    iobuf = jiobuf if name == "jax" else tiobuf
    data = _seeded(5000, seed=1).tobytes()
    buf = iobuf.IOBuf()
    buf.append(data[:1200])
    buf.append(data[1200:])
    r, w = os.pipe()
    try:
        n = buf.copy_to_file_descriptor(w)
        os.close(w)
        w = -1
        got = b""
        while True:
            chunk = os.read(r, 1 << 16)
            if not chunk:
                break
            got += chunk
    finally:
        os.close(r)
        if w >= 0:
            os.close(w)
    return {"written": n, "read": got, "size_after": len(buf),
            "still": buf.to_bytes()}


def _iobuf_append_device_array_unchecked(name):
    iobuf = jiobuf if name == "jax" else tiobuf
    data = _seeded(4096, seed=2)
    if name == "jax":
        import jax.numpy as jnp
        arr = jnp.asarray(data)
    else:
        arr = torch.from_numpy(data.copy())
    buf = iobuf.IOBuf()
    buf.append(b"head")
    buf.append_device_array_unchecked(arr, data.size)
    return {"size": len(buf), "bytes": buf.to_bytes(),
            "kinds": [r.block.kind == iobuf.DEVICE for r in buf._refs]}


def _block_cap(name):
    iobuf = jiobuf if name == "jax" else tiobuf
    return {n: iobuf.new_host_block(n).cap for n in (1, 100, 8192, 70000)}


def _hostname2endpoint(name):
    ep = (jendpoint if name == "jax" else tendpoint).hostname2endpoint
    return [(e.scheme, e.host, e.port, str(e))
            for e in (ep("localhost:80"), ep("127.0.0.1:8002"))]


def _logging(name):
    log = jlog if name == "jax" else tlog
    logger = log._logger
    seen = []

    class Grab(pylog.Handler):
        def emit(self, record):
            seen.append((record.levelno, record.getMessage()))
    grab = Grab()
    level = logger.level
    logger.addHandler(grab)
    try:
        log.set_min_log_level(log.INFO)
        vlog_at_info = log.vlog_is_on(1)
        log.log(log.WARNING, "w %d", 1)
        log.log(pylog.DEBUG, "hidden at INFO")
        for _ in range(9):            # 3 of every 9 calls from one site
            log.log_every_n(log.ERROR, 3, "every %s", "3rd")
        log.set_min_log_level(pylog.DEBUG)
        vlog_at_debug = log.vlog_is_on(1)
        log.log(pylog.DEBUG, "shown at DEBUG")
        log.set_min_log_level(log.ERROR)
        log.info("hidden at ERROR")
        with pytest.raises(SystemExit) as exc:
            log.fatal("bye %s", "now")
        return {"records": seen, "vlog": (vlog_at_info, vlog_at_debug),
                "exit": str(exc.value), "FATAL": log.FATAL}
    finally:
        logger.removeHandler(grab)
        logger.setLevel(level)


def _register_compression(name):
    compress = jcompress if name == "jax" else tcompress
    ctype = 97
    compress.register_compression(ctype, lambda b: b[::-1] + b"!",
                                  lambda b: b[:-1][::-1])
    try:
        data = _seeded(300, seed=3).tobytes()
        packed = compress.compress(ctype, data)
        return {"packed": packed,
                "round_trip": compress.decompress(ctype, packed) == data}
    finally:
        compress._codecs.pop(ctype, None)


def _flag_reloadable(name):
    flags = jflags if name == "jax" else tflags
    return [flags.Flag("parity_a", 1, "h").reloadable,
            flags.Flag("parity_b", 1, "h", reloadable=False).reloadable,
            flags.Flag("parity_c", 1, "h", validator=flags.positive_integer,
                       reloadable=False).reloadable,
            flags.Flag("parity_d", 1, "h",
                       validator=flags.positive_integer).reloadable]


# ---- rpc ------------------------------------------------------------------

def _rpc(name):
    return (jrpc, jpb) if name == "jax" else (trpc, tpb)


def _echo(rpc, pb, seen=None):
    class EchoService(rpc.Service):
        @rpc.method(pb.EchoRequest, pb.EchoResponse)
        def Echo(self, cntl, request, response, done):
            if seen is not None:
                seen.append((str(cntl.local_side), str(cntl.remote_side)))
            response.message = "parity:" + request.message
            done()
    return EchoService()


def _handle_parsed_http_response(name):
    rpc, pb = _rpc(name)
    server = rpc.Server()
    server.add_service(_echo(rpc, pb))
    assert server.start("127.0.0.1:0") == 0
    ch = rpc.Channel()
    try:
        ch.init(f"127.0.0.1:{server.listen_port}", options=rpc.ChannelOptions(
            protocol="http", timeout_ms=5000))
        cntl = rpc.Controller()
        before = cntl.http_response
        resp = ch.call_method("EchoService.Echo", cntl,
                              pb.EchoRequest(message="http"),
                              pb.EchoResponse)
        assert not cntl.failed(), cntl.error_text
        msg = cntl.http_response
        return {"before": before, "status": msg.status,
                "message": resp.message, "body": msg.body}
    finally:
        ch.close()
        server.stop()


def _local_side(name):
    rpc, pb = _rpc(name)
    seen = []
    server = rpc.Server()
    server.add_service(_echo(rpc, pb, seen))
    assert server.start("mem://surface-parity") == 0
    ch = rpc.Channel()
    try:
        ch.init("mem://surface-parity")
        cntl = rpc.Controller()
        ch.call_method("EchoService.Echo", cntl,
                       pb.EchoRequest(message="side"), pb.EchoResponse)
        assert not cntl.failed(), cntl.error_text
        return {"server_saw": seen, "client_default": cntl.local_side}
    finally:
        ch.close()
        server.stop()


def _input_messenger_protocols(name):
    protocol = jprotocol if name == "jax" else tprotocol
    messenger = jmessenger if name == "jax" else tmessenger
    every = messenger.InputMessenger().protocols()
    some = [protocol.find_protocol("tpu_std"), protocol.find_protocol("http")]
    return {"default_is_registry": [p.name for p in every]
            == [p.name for p in protocol.list_protocols()],
            "given": [p.name for p in messenger.InputMessenger(
                some).protocols()],
            "has_tpu_std_and_http": {"tpu_std", "http"}
            <= {p.name for p in every}}


# ---- ici and channels -------------------------------------------------------

@pytest.fixture()
def plane_flags():
    names = ("ici_device_plane", "ici_device_plane_host_mesh",
             "ici_device_plane_threshold")
    saved = {n: tflags.get_flag(n) for n in names}
    jsaved = {n: jflags.get_flag(n) for n in names}
    for f in (tflags, jflags):
        f.set_flag("ici_device_plane", True)
        f.set_flag("ici_device_plane_host_mesh", True)
        f.set_flag("ici_device_plane_threshold", 1024)
    yield
    for n, v in saved.items():
        tflags.set_flag(n, v)
    for n, v in jsaved.items():
        jflags.set_flag(n, v)


def _transfer_local(name):
    data = _seeded(8192, seed=4)
    if name == "jax":
        import jax
        dp, mesh = jdp, JaxMesh.default()
        arr = jax.device_put(data, mesh.device(2))
        loose = data
    else:
        dp, mesh = tdp, IciMesh.default()
        arr = mesh.device_put(torch.from_numpy(data.copy()), 2)
        loose = torch.from_numpy(data.copy())
    plane = dp.plane()
    t = plane.transfer_local(arr, 2, 5)
    rc = t.wait(30)
    deadline = time.monotonic() + 5
    while plane.active_transfers() and time.monotonic() < deadline:
        time.sleep(0.005)
    out = t.out if name == "jax" else t.out.numpy()
    return {"rc": rc, "src_rank": dp.mesh_index_of(arr),
            "dst_rank": dp.mesh_index_of(t.out), "bytes": bytes(np.asarray(
                out)), "loose_rank": dp.mesh_index_of(loose),
            "plane_mesh_is_default": plane.mesh() is mesh,
            "ranks": (t.src_dev, t.dst_dev)}


def _collective_registry_serving(name):
    fanout = jfanout if name == "jax" else tfanout
    reg = fanout.CollectiveRegistry()
    trail = [reg.serving(3)]
    reg.serve(3)
    reg.serve(3)                 # a restart's overlap: counted
    trail.append(reg.serving(3))
    reg.withdraw(3)
    trail.append(reg.serving(3))
    reg.withdraw(3)
    trail += [reg.serving(3), reg.serving(4)]
    return trail


def _ici_transport_stats(name):
    """An ``ici://3`` echo of a 4096-byte DEVICE attachment owned by rank
    2, read through the package's ``ici_transport_stats``."""
    data = _seeded(4096, seed=5)
    if name == "jax":
        import jax
        from brpc_tpu import ici
        rpc, pb = jrpc, jpb
        arr = jax.device_put(data, JaxMesh.default().device(2))
    else:
        from brpc_tpu_torch import ici
        rpc, pb = trpc, tpb
        arr = IciMesh.default().device_put(torch.from_numpy(data.copy()), 2)
    server = rpc.Server()
    server.add_service(_echo_service(rpc, pb))
    assert server.start("ici://3") == 0
    try:
        ch = rpc.Channel()
        ch.init("ici://3")
        total0, dev0 = ici.ici_transport_stats()
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(arr)
        ch.call_method("EchoService.Echo", cntl, pb.EchoRequest(message="s"),
                       pb.EchoResponse)
        total1, dev1 = ici.ici_transport_stats()
        ch.close()
    finally:
        server.stop()
    return {"failed": cntl.failed(), "device_bytes": dev1 - dev0,
            "host_bytes_too": total1 - total0 > dev1 - dev0,
            "echoed": cntl.response_attachment.to_bytes() == data.tobytes()}


def _echo_service(rpc, pb):
    class EchoService(rpc.Service):
        @rpc.method(pb.EchoRequest, pb.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()
    return EchoService()


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _health_check(name):
    """``probe_endpoint``, ``HealthCheckTask`` and ``start_health_check``
    through the package's ``rpc`` names: probes of served and unserved
    endpoints, the seeded backoff, a revival gated by the application
    probe, one that the application probe refuses, and revival callbacks
    kept apart or replaced by their keys."""
    rpc, pb, endpoint = ((jrpc, jpb, jendpoint) if name == "jax"
                         else (trpc, tpb, tendpoint))
    from importlib import import_module
    hc = import_module(rpc.__name__ + ".health_check")
    ep = endpoint.parse_endpoint(f"mem://parity-hc-{name}")
    refused = endpoint.parse_endpoint(f"mem://parity-hc-refused-{name}")
    out = {"unserved": rpc.probe_endpoint(ep),
           "tcp_closed": rpc.probe_endpoint(
               endpoint.parse_endpoint("127.0.0.1:1"), timeout=0.2)}
    task = rpc.HealthCheckTask(ep, max_probes=1, seed=42)
    delays = []
    for count in (0, 1, 2, 3, 10):
        task.probe_count = count
        delays.append(task.next_delay_s())
    task.cancel()
    out["delays"] = delays
    fired = []
    first = rpc.start_health_check(ep, on_revived=lambda e: fired.append("a"),
                                   revive_key="a")
    rpc.start_health_check(ep, on_revived=lambda e: fired.append("b"),
                           revive_key="b")
    rpc.start_health_check(ep, on_revived=lambda e: fired.append("b2"),
                           revive_key="b")
    checked = []
    gated = rpc.HealthCheckTask(
        ep, on_revived=lambda e: fired.append("gated"),
        app_check=lambda e: checked.append(str(e)) or True, seed=7)
    never = rpc.start_health_check(refused, app_check=lambda e: False)
    servers = []
    for addr in (ep, refused):
        server = rpc.Server()
        server.add_service(_echo_service(rpc, pb))
        assert server.start(str(addr)) == 0
        servers.append(server)
    try:
        out["served"] = rpc.probe_endpoint(ep)
        out["revived"] = _wait(lambda: not hc.checking(ep)
                               and len(fired) == 3)
        out["fired"] = sorted(fired)
        out["app_checked"] = checked[:1] == [str(ep)]
        out["refused_probes"] = _wait(lambda: never.probe_count >= 2)
        out["refused_still_checking"] = hc.checking(refused)
        out["first_probes_counted"] = first.probe_count >= 1
    finally:
        never.cancel()
        gated.cancel()
        for server in servers:
            server.stop()
    return out


# ---- codec ----------------------------------------------------------------

def _pb2json(name):
    json2pb, track = (jjson, jtrack) if name == "jax" else (tjson, ttrack)
    msg = track.TrackMeResponse(severity=track.TRACKME_WARNING)
    empty = track.TrackMeResponse()
    out = {}
    for label, opts in {
            "default": None,
            "primitive": json2pb.Pb2JsonOptions(
                always_print_primitive_fields=True),
            "enum_number": json2pb.Pb2JsonOptions(enum_option_as_number=True),
            "both": json2pb.Pb2JsonOptions(
                always_print_primitive_fields=True,
                enum_option_as_number=True)}.items():
        out[label] = [json2pb.pb_to_json(m, opts) for m in (msg, empty)]
    out["dict"] = [json2pb.pb_to_dict(m) for m in (msg, empty)]
    return out


CASES = {
    "iobuf_copy_to": _iobuf_copy_to,
    "iobuf_copy_to_file_descriptor": _iobuf_copy_to_file_descriptor,
    "iobuf_append_device_array_unchecked":
        _iobuf_append_device_array_unchecked,
    "block_cap": _block_cap,
    "hostname2endpoint": _hostname2endpoint,
    "logging": _logging,
    "register_compression": _register_compression,
    "flag_reloadable": _flag_reloadable,
    "handle_parsed_http_response": _handle_parsed_http_response,
    "local_side": _local_side,
    "input_messenger_protocols": _input_messenger_protocols,
    "collective_registry_serving": _collective_registry_serving,
    "pb2json_options": _pb2json,
    "health_check": _health_check,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", PKGS)
def test_ported_name_behaves_like_jax(name, case):
    got = CASES[case](name)
    assert got == CASES[case]("jax")


@pytest.mark.parametrize("name", PKGS)
def test_transfer_local_and_mesh_index_of_like_jax(name, plane_flags):
    got = _transfer_local(name)
    assert got == _transfer_local("jax")
    assert got["rc"] == 0 and (got["src_rank"], got["dst_rank"]) == (2, 5)
    assert got["bytes"] == _seeded(8192, seed=4).tobytes()
    assert got["loose_rank"] == -1 and got["plane_mesh_is_default"]


@pytest.mark.parametrize("name", PKGS)
def test_ici_transport_stats_like_jax(name):
    got = _ici_transport_stats(name)
    assert got == _ici_transport_stats("jax")
    assert got == {"failed": False, "device_bytes": 4096,
                   "host_bytes_too": True, "echoed": True}


def test_cases_see_what_a_caller_sees():
    """The expectations each case's equality rests on, spelled out once
    on the port."""
    assert _iobuf_copy_to("port")["mid"] == _seeded(3000).tobytes()[995:1005]
    assert _iobuf_copy_to("port")["size_after"] == 3003
    fd = _iobuf_copy_to_file_descriptor("port")
    assert fd["written"] == 5000 and fd["read"] == fd["still"]
    dev = _iobuf_append_device_array_unchecked("port")
    assert dev["kinds"] == [False, True] and dev["size"] == 4100
    assert _hostname2endpoint("port")[0][1:3] == ("127.0.0.1", 80)
    logged = _logging("port")
    assert logged["records"].count((pylog.ERROR, "every 3rd")) == 3
    assert logged["vlog"] == (False, True) and logged["exit"] == "bye now"
    assert _flag_reloadable("port") == [True, False, False, True]
    http = _handle_parsed_http_response("port")
    assert http["before"] is None and http["status"] == 200
    assert _collective_registry_serving("port") == [False, True, True,
                                                    False, False]
    hc = _health_check("port")
    assert (hc["unserved"], hc["tcp_closed"], hc["served"]) == (
        False, False, True)
    assert 0.1 <= hc["delays"][0] < 0.125 and 2.0 <= hc["delays"][4] < 2.5
    assert hc["revived"] and hc["fired"] == ["a", "b2", "gated"]
    assert hc["app_checked"]
    assert hc["refused_probes"] and hc["refused_still_checking"]
