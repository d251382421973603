"""The storage and Baidu-legacy protocols across the two packages, and all
of them on one port.

* Each package's client against the other's server over TCP, for every
  protocol: tpu_std, HTTP and gRPC beside redis, thrift, mongo, raw
  nshead, hulu, sofa, nova, public_pbrpc, esp and ubrpc (mcpack2 and
  compack).  The four client/server pairings must give equal answers.
  The redis case pipelines 16 commands in one call; memcache, which is
  client-only in both packages as in the reference, calls one
  ``mini_memcached`` from both clients.
* One port server carrying every protocol at once
  (``brpc_tpu_torch.tools.multi_protocol``), every reply checked, and the
  golden RESP and memcache fixture bytes on a raw socket.
* The rpc layer's hooks these protocols need: the pipelined context a
  protocol builds, the adaptive pooled default, the connection-level
  service slots with their single-owner rule, the registration order.
"""
from __future__ import annotations

import socket as pysocket
import threading
import types

import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil.iobuf import IOBuf as JBuf
from brpc_tpu.codec import mcpack as jmcpack
from brpc_tpu.policy import (esp as jesp, legacy_pbrpc as jlegacy,
                             memcache as jmemcache, mongo as jmongo,
                             nova as jnova, nshead as jnshead,
                             public_pbrpc as jpublic, redis as jredis,
                             thrift as jthrift, ubrpc as jubrpc)
from brpc_tpu.rpc.protocol import list_protocols as jlist
from brpc_tpu_torch.rpc.protocol import list_protocols as tlist
from brpc_tpu_torch.tools import multi_protocol as mp
from brpc_tpu_torch.tools.mini_memcached import MiniMemcached
from tests.echo_pb2 import EchoRequest, EchoResponse
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

JAX = types.SimpleNamespace(
    rpc=jrpc, IOBuf=JBuf, mcpack=jmcpack, esp=jesp, legacy_pbrpc=jlegacy,
    memcache=jmemcache, mongo=jmongo, nova=jnova, nshead=jnshead,
    public_pbrpc=jpublic, redis=jredis, thrift=jthrift, ubrpc=jubrpc,
    EchoRequest=EchoRequest, EchoResponse=EchoResponse)
PORT = mp.port_modules()
PKGS = {"jax": JAX, "port": PORT}
PAIRS = [("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port")]


@pytest.fixture
def servers():
    """One every-protocol server per package, and one memcached (per
    test: a stop closes every connection the test's clients opened)."""
    out = {name: mp.start_server(m) for name, m in PKGS.items()}
    mc = MiniMemcached().start()
    yield out, mc
    mc.stop()
    for s in out.values():
        s.stop()


def _port(server):
    return server.listen_port


@pytest.mark.parametrize("proto", mp.ECHO_PROTOCOLS)
def test_each_client_against_each_server(servers, proto):
    srv, mc = servers
    answers = {}
    for client, server in PAIRS:
        clients = mp.Clients(PKGS[client], _port(srv[server]), mc.port)
        try:
            got = [clients.echo(proto, f"{proto}-{client}-{i}-" + "x" * i)
                   for i in (0, 7, 4096)]
        finally:
            clients.close()
        assert got == [f"{proto}-{client}-{i}-" + "x" * i
                       for i in (0, 7, 4096)], (client, server)
        answers[(client, server)] = [g.replace(client, "") for g in got]
    assert len({tuple(v) for v in answers.values()}) == 1, answers


def test_redis_pipelined_16_across_packages(servers):
    """16 commands in one call, each pairing from the same seeded
    memtier mix, against what a correct store answers."""
    srv, mc = servers
    for client, server in PAIRS:
        ops = mp.memtier_ops(16 * 8, seed=5, keys=40)
        clients = mp.Clients(PKGS[client], _port(srv[server]), mc.port)
        try:
            keys = sorted({k for _o, k, _v in ops})
            assert all(clients.kv("redis", [("set", k, b"0")
                                            for k in keys]))
            store = {k: b"0" for k in keys}
            for i in range(0, len(ops), 16):
                batch = ops[i:i + 16]
                assert clients.kv("redis", batch) == \
                    mp.expected_kv(batch, store), (client, server, i)
        finally:
            clients.close()


def test_memcache_clients_of_both_packages():
    """Both packages' memcache clients, pipelined 16 deep, against one
    memcached: equal answers, and those of a correct store."""
    answers = {}
    for client in PKGS:
        mc = MiniMemcached().start()
        clients = mp.Clients(PKGS[client], 0, mc.port)
        try:
            ops = mp.memtier_ops(16 * 8, seed=9, keys=40)
            store = {}
            got = []
            for i in range(0, len(ops), 16):
                batch = ops[i:i + 16]
                res = clients.kv("memcache", batch)
                assert res == mp.expected_kv(batch, store), (client, i)
                got.append(res)
            answers[client] = got
            assert mc.frames == len(ops)
        finally:
            clients.close()
            mc.stop()
    assert answers["jax"] == answers["port"]


def test_one_port_server_answers_every_protocol():
    """A port server holds tpu_std, HTTP, gRPC and every new protocol on
    one port; a client of each calls it, redis and memcache at
    memtier's mix and pipeline depths 1 and 16."""
    server = mp.start_server(PORT)
    mc = MiniMemcached().start()
    try:
        res = mp.drive(PORT, server.listen_port, mc.port, calls=3,
                       payload_bytes=4096, kv_ops=64)
        for proto in mp.ECHO_PROTOCOLS:
            assert res[proto]["calls"] == 3
        for key in ("redis_d1", "redis_d16", "memcache_d1",
                    "memcache_d16"):
            assert res[key]["ops"] == 64
        # the JAX clients on the same port
        jres = mp.drive(JAX, server.listen_port, mc.port, calls=2,
                        payload_bytes=64, kv_ops=32)
        assert set(jres) == set(res)
    finally:
        mc.stop()
        server.stop()


def _raw_exchange(port, data: bytes, want: int) -> bytes:
    with pysocket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(data)
        got = b""
        while len(got) < want:
            chunk = s.recv(65536)
            if not chunk:
                break
            got += chunk
        return got


def test_golden_resp_bytes_on_a_raw_socket():
    """The golden command bytes of the wire fixtures, written on a raw
    socket to the every-protocol port server, answer the golden replies."""
    server = mp.start_server(PORT)
    try:
        req = (b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"
               b"*2\r\n$3\r\nGET\r\n$1\r\nk\r\n"
               b"*2\r\n$3\r\nGET\r\n$4\r\nnone\r\n"
               b"*1\r\n$4\r\nPING\r\n")
        want = b"+OK\r\n$1\r\nv\r\n$-1\r\n+PONG\r\n"
        assert _raw_exchange(server.listen_port, req, len(want)) == want
    finally:
        server.stop()


def test_golden_memcache_bytes_on_a_raw_socket():
    """The wire fixtures' GET request bytes against memcached, and the
    port client's SET + GET bytes are exactly those frames."""
    mc = MiniMemcached().start()
    try:
        get = bytes.fromhex("80000003000000000000000300000000"
                            "0000000000000000") + b"foo"
        hdr = bytes.fromhex("81000000040000000000000700000000"
                            "0000000000000000")
        miss = _raw_exchange(mc.port, get, 24)
        assert miss[:2] == b"\x81\x00" and miss[6:8] == b"\x00\x01"
        req = PORT.memcache.MemcacheRequest()
        req.set("foo", "bar")
        assert _raw_exchange(mc.port, req.serialize(), 24)[6:8] == \
            b"\x00\x00"
        got = _raw_exchange(mc.port, get, 31)
        assert got == hdr + b"\x00\x00\x00\x00bar"
    finally:
        mc.stop()


# ---- the rpc layer's hooks -------------------------------------------

def test_registration_order_is_the_reference_order():
    """The messenger tries protocols in this order: the port's list is
    the JAX package's without the media family."""
    names = [p.name for p in jlist() if p.name not in ("rtmp",)]
    assert [p.name for p in tlist()] == names


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_connection_level_slots_and_single_owner(pkg):
    m = PKGS[pkg]
    server = m.rpc.Server()
    svcs = mp.make_services(m)
    for svc in svcs:
        assert server.add_service(svc) == 0
    assert server.redis_service is svcs[1]
    assert server.thrift_service is svcs[2]
    assert server._mongo_service is svcs[3]
    assert server._nshead_service is svcs[4]
    assert server._esp_service is svcs[5]
    # nshead and esp take one owner each
    assert server.add_service(mp.nshead_router(m)) == m.rpc.errors.EINVAL
    assert server.add_service(m.esp.EspService()) == m.rpc.errors.EINVAL
    assert server._nshead_service is svcs[4]


@pytest.mark.parametrize("proto,pooled", [("nshead", True),
                                          ("esp", True),
                                          ("memcache", False),
                                          ("redis", False)])
def test_adaptive_connection_type(servers, proto, pooled):
    """With ``connection_type`` unset, a protocol without single
    connections takes a pooled one per call, so concurrent calls never
    share a connection; a protocol with single connections keeps the
    shared one."""
    srv, mc = servers
    port = mc.port if proto == "memcache" else _port(srv["port"])
    ch = PORT.rpc.Channel()
    ch.init(f"127.0.0.1:{port}", options=PORT.rpc.ChannelOptions(
        protocol=proto, timeout_ms=10000))
    cntls, errs = [], []

    def call(i):
        cntl = PORT.rpc.Controller()
        if proto == "nshead":
            req = PORT.nshead.NsheadMessage()
            req.head.provider = mp.RAW_PROVIDER
            req.body.append(b"m%d" % i)
            want = b"m%d" % i
        elif proto == "esp":
            req = PORT.esp.EspMessage()
            req.body.append(b"e%d" % i)
            want = b"e%d" % i
        elif proto == "redis":
            req = PORT.redis.RedisRequest()
            req.add_command("PING")
        else:
            req = PORT.memcache.MemcacheRequest()
            req.version()
        resp = ch.call_method(proto, cntl, req, None)
        if cntl.failed():
            errs.append(cntl.error_text_)
        elif proto in ("nshead", "esp"):
            assert resp.body.to_bytes() == want
        cntls.append(cntl)

    try:
        ts = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not errs and len(cntls) == 8
        for cntl in cntls:
            took = cntl.__dict__.get("_pooled_sockets") or []
            assert bool(took) is pooled, proto
    finally:
        ch.close()


def test_pipeline_context_is_the_protocols_own():
    """A redis call queues a context expecting one reply per command;
    nshead's client knows its answers by the context's type; HTTP's stays
    the bare cid."""
    srv = mp.start_server(PORT)
    seen = {}
    from brpc_tpu_torch.rpc import socket as tsocket
    orig = tsocket.Socket.push_pipelined_context

    def spy(self, ctx):
        seen.setdefault(type(ctx).__name__, ctx)
        return orig(self, ctx)

    tsocket.Socket.push_pipelined_context = spy
    clients = mp.Clients(PORT, srv.listen_port)
    try:
        clients.kv("redis", [("set", "a", b"1"), ("get", "a", b""),
                             ("get", "b", b"")])
        clients.echo("nshead", "n")
        clients.echo("http", "h")
    finally:
        tsocket.Socket.push_pipelined_context = orig
        clients.close()
        srv.stop()
    assert seen["_PipelinedRedisCtx"].expected == 3
    assert isinstance(seen["NsheadCallCtx"], PORT.nshead.NsheadCallCtx)
    assert isinstance(seen["int"], int)
