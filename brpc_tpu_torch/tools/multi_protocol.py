"""Every wire protocol of the package on one TCP server port.

``start_server(m)`` starts a server that holds tpu_std, HTTP and gRPC (an
``EchoService``), redis (a key-value ``RedisService``), thrift (an
``Echo`` method), mongo (an echoing ``MongoService``), the nshead family
behind its one nshead owner (``NsheadRouter``: raw nshead, nova_pbrpc,
public_pbrpc and ubrpc in both formats), hulu and sofa (the same
``EchoService``) and esp (an echoing ``EspService``), all on one port.
``Clients(m, port)`` holds one channel per protocol and ``echo(proto,
payload)`` makes one call and returns what came back; ``kv(proto, ops)``
drives redis or memcache with a batch of set/get operations in one call.
memcache is client-only, as in the reference: ``mini_memcached`` stands in
for the memcached it calls.

``m`` is a namespace of one package's modules: ``port_modules()`` gives
this package's, and a test may hand in another package with the same
module names, whose client then calls this package's server or the other
way round.

Usage (prints each protocol's reply check and p50/p99 in µs):
    python -m brpc_tpu_torch.tools.multi_protocol [--calls 200]
"""
from __future__ import annotations

import argparse
import json
import time
import types
from typing import Any, Dict, List, Optional, Tuple

# the echo protocols and what each call carries
PB_PROTOCOLS = ("tpu_std", "http", "grpc", "hulu_pbrpc", "sofa_pbrpc",
                "nova_pbrpc", "public_pbrpc", "ubrpc_mcpack2",
                "ubrpc_compack")
ECHO_PROTOCOLS = PB_PROTOCOLS + ("thrift", "mongo", "nshead", "esp")
RAW_PROVIDER = b"raw"
THRIFT_SPEC = {1: ("data", 11)}          # TType.STRING
NOVA_ECHO_INDEX = 0                      # name-sorted: Echo=0, Fail=1


def port_modules() -> types.SimpleNamespace:
    """This package's modules under the names the builders use."""
    import brpc_tpu_torch.policy  # noqa: F401  (registers the protocols)
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.codec import mcpack
    from brpc_tpu_torch.policy import (esp, legacy_pbrpc, memcache, mongo,
                                       nova, nshead, public_pbrpc, redis,
                                       thrift, ubrpc)
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    return types.SimpleNamespace(
        rpc=rpc, IOBuf=IOBuf, mcpack=mcpack, esp=esp,
        legacy_pbrpc=legacy_pbrpc, memcache=memcache, mongo=mongo,
        nova=nova, nshead=nshead, public_pbrpc=public_pbrpc, redis=redis,
        thrift=thrift, ubrpc=ubrpc, EchoRequest=EchoRequest,
        EchoResponse=EchoResponse)


def make_services(m) -> list:
    """The services one server port needs for every protocol."""
    rpc = m.rpc

    class EchoService(rpc.Service):
        @rpc.method(m.EchoRequest, m.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

        @rpc.method(m.EchoRequest, m.EchoResponse)
        def Fail(self, cntl, request, response, done):
            cntl.set_failed(rpc.errors.EINTERNAL, "deliberate failure")
            done()

    class KvRedis(m.redis.RedisService):
        def __init__(self):
            super().__init__()
            self.data: Dict[bytes, bytes] = {}
            self.add_handler("SET", self._set)
            self.add_handler("GET", self._get)
            self.add_handler("INCR", self._incr)

        def _set(self, args):
            self.data[bytes(args[0])] = bytes(args[1])
            return m.redis.RedisReply(m.redis.REPLY_STATUS, "OK")

        def _get(self, args):
            return self.data.get(bytes(args[0]))

        def _incr(self, args):
            v = int(self.data.get(bytes(args[0]), b"0")) + 1
            self.data[bytes(args[0])] = str(v).encode()
            return v

    thrift = m.thrift.ThriftService()
    thrift.add_method("Echo", lambda args: {"data": args["data"]},
                      THRIFT_SPEC, THRIFT_SPEC)

    class MongoEcho(m.mongo.MongoService):
        def process(self, cntl, doc):
            return {"ok": 1, "echoed": doc.get("echo")}

    class EspEcho(m.esp.EspService):
        def process_esp_request(self, server, cntl, request, response,
                                done):
            response.body.append(request.body)
            done()

    return [EchoService(), KvRedis(), thrift, MongoEcho(),
            nshead_router(m), EspEcho()]


def nshead_router(m):
    """The server's one nshead owner, dispatching the family by what each
    client puts on the wire: public_pbrpc's head version, an mcpack body
    (ubrpc), the raw client's provider, and nova for the rest."""
    raw_cls = m.nshead.NsheadService

    class RawEcho(raw_cls):
        def process_nshead_request(self, server, cntl, request, response,
                                   done):
            response.body.append(request.body)
            done()

    class NsheadRouter(raw_cls):
        def __init__(self):
            self.public = m.public_pbrpc.PublicPbrpcServiceAdaptor()
            self.ubrpc = m.ubrpc.UbrpcAdaptor()
            self.nova = m.nova.NovaServiceAdaptor("EchoService")
            self.raw = RawEcho()

        def pick(self, request):
            if request.head.version == m.public_pbrpc.NSHEAD_VERSION:
                return self.public
            if request.body.fetch(1) == b"\x10":     # an mcpack object
                return self.ubrpc
            if request.head.provider == RAW_PROVIDER:
                return self.raw
            return self.nova

        def process_nshead_request(self, server, cntl, request, response,
                                   done):
            self.pick(request).process_nshead_request(
                server, cntl, request, response, done)

    return NsheadRouter()


def start_server(m, where: str = "127.0.0.1:0", options=None):
    """A started server holding every protocol's service."""
    server = m.rpc.Server(options)
    for svc in make_services(m):
        rc = server.add_service(svc)
        if rc != 0:
            raise RuntimeError(f"add_service({type(svc).__name__}) = {rc}")
    if server.start(where) != 0:
        raise RuntimeError(f"server did not start on {where}")
    return server


class Clients:
    """One channel per protocol to ``127.0.0.1:port`` (memcache's to
    ``mc_port``)."""

    def __init__(self, m, port: int, mc_port: Optional[int] = None,
                 timeout_ms: int = 10000):
        self.m = m
        self.port = port
        self.mc_port = mc_port
        self.timeout_ms = timeout_ms
        self._chans: Dict[str, Any] = {}

    def channel(self, proto: str):
        ch = self._chans.get(proto)
        if ch is None:
            ch = self.m.rpc.Channel()
            port = self.mc_port if proto == "memcache" else self.port
            ch.init(f"127.0.0.1:{port}", options=self.m.rpc.ChannelOptions(
                protocol=proto, timeout_ms=self.timeout_ms, max_retry=0))
            self._chans[proto] = ch
        return ch

    def close(self) -> None:
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()

    def _call(self, proto, method, request, response_cls=None, cntl=None):
        m = self.m
        cntl = cntl or m.rpc.Controller()
        resp = self.channel(proto).call_method(method, cntl, request,
                                               response_cls)
        if cntl.failed():
            raise RuntimeError(f"{proto}: [{cntl.error_code_}] "
                               f"{cntl.error_text_}")
        return resp

    def echo(self, proto: str, payload: str) -> Any:
        """One echo call of ``payload`` over ``proto``; returns the echoed
        value as the protocol hands it back."""
        m = self.m
        if proto in PB_PROTOCOLS:
            cntl = m.rpc.Controller()
            if proto == "nova_pbrpc":
                cntl.method_index = NOVA_ECHO_INDEX
            resp = self._call(proto, "EchoService.Echo",
                              m.EchoRequest(message=payload),
                              m.EchoResponse, cntl)
            return resp.message
        if proto == "thrift":
            req = m.thrift.ThriftMessage("Echo", {"data": payload},
                                         THRIFT_SPEC, THRIFT_SPEC)
            return self._call(proto, "Echo", req).values["data"].decode()
        if proto == "mongo":
            resp = self._call(proto, "mongo",
                              m.mongo.MongoRequest({"echo": payload}))
            return resp.doc["echoed"]
        if proto == "nshead":
            req = m.nshead.NsheadMessage()
            req.head.provider = RAW_PROVIDER
            req.body.append(payload.encode())
            return self._call(proto, "", req).body.to_bytes().decode()
        if proto == "esp":
            req = m.esp.EspMessage()
            req.head.msg = 7
            req.body.append(payload.encode())
            return self._call(proto, "", req).body.to_bytes().decode()
        raise ValueError(f"no echo for {proto!r}")

    def kv(self, proto: str, ops: List[Tuple[str, str, bytes]]) -> list:
        """One call carrying ``ops`` (("set", key, value) or ("get", key,
        b"")) over redis or memcache; returns each op's result: True for
        a stored set, the value (or None) for a get."""
        m = self.m
        if proto == "redis":
            req = m.redis.RedisRequest()
            for op, key, value in ops:
                if op == "set":
                    req.add_command("SET", key, value)
                else:
                    req.add_command("GET", key)
            resp = self._call(proto, "redis", req)
            out = []
            for (op, _k, _v), r in zip(ops, resp.replies):
                if op == "set":
                    out.append(r.value == "OK")
                else:
                    out.append(None if r.type == m.redis.REPLY_NIL
                               else bytes(r.value))
            return out
        if proto == "memcache":
            req = m.memcache.MemcacheRequest()
            for op, key, value in ops:
                if op == "set":
                    req.set(key, value)
                else:
                    req.get(key)
            resp = self._call(proto, "memcache", req)
            out = []
            for (op, _k, _v), r in zip(ops, resp.ops):
                if op == "set":
                    out.append(r.ok())
                else:
                    out.append(bytes(r.value) if r.ok() else None)
            return out
        raise ValueError(f"no kv for {proto!r}")


def memtier_ops(n: int, seed: int = 0, keys: int = 1000,
                value_bytes: int = 32, ratio: Tuple[int, int] = (1, 10)
                ) -> List[Tuple[str, str, bytes]]:
    """memtier_benchmark's default mix: ``value_bytes``-byte values and
    set:get at ``ratio``, over a key space of ``keys`` (seeded)."""
    import random
    rng = random.Random(seed)
    period = ratio[0] + ratio[1]
    out = []
    for i in range(n):
        key = "memtier-%d" % rng.randrange(keys)
        if i % period < ratio[0]:
            value = bytes(rng.randrange(33, 127) for _ in range(value_bytes))
            out.append(("set", key, value))
        else:
            out.append(("get", key, b""))
    return out


def expected_kv(ops, store: Dict[str, bytes]) -> list:
    """What a correct key-value server answers to ``ops`` from ``store``
    (updated in place)."""
    out = []
    for op, key, value in ops:
        if op == "set":
            store[key] = value
            out.append(True)
        else:
            out.append(store.get(key))
    return out


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def drive(m, port: int, mc_port: int, calls: int = 200,
          payload_bytes: int = 4096, kv_ops: int = 2000,
          depths=(1, 16)) -> dict:
    """Every protocol's echo ``calls`` times with a ``payload_bytes``
    payload, then redis and memcache through ``kv_ops`` memtier
    operations at each pipeline depth; every reply checked.  Returns p50
    and p99 µs per call."""
    clients = Clients(m, port, mc_port)
    out: Dict[str, Any] = {}
    try:
        for proto in ECHO_PROTOCOLS:
            lat = []
            for i in range(calls + 5):
                payload = chr(97 + i % 26) * payload_bytes
                t = time.perf_counter_ns()
                got = clients.echo(proto, payload)
                us = (time.perf_counter_ns() - t) / 1e3
                if got != payload:
                    raise AssertionError(f"{proto} echo {i}: wrong reply")
                if i >= 5:
                    lat.append(us)
            out[proto] = {"calls": calls, "p50_us": _pct(lat, 0.5),
                          "p99_us": _pct(lat, 0.99)}
        for proto in ("redis", "memcache"):
            for depth in depths:
                ops = memtier_ops(kv_ops, seed=depth)
                store: Dict[str, bytes] = {}
                # the server's store starts where the previous leg ended:
                # seed it to a known state first
                keys = sorted({k for _op, k, _v in ops})
                clients.kv(proto, [("set", k, b"-") for k in keys])
                store.update({k: b"-" for k in keys})
                lat = []
                for i in range(0, len(ops), depth):
                    batch = ops[i:i + depth]
                    t = time.perf_counter_ns()
                    got = clients.kv(proto, batch)
                    lat.append((time.perf_counter_ns() - t) / 1e3)
                    if got != expected_kv(batch, store):
                        raise AssertionError(
                            f"{proto} depth {depth} batch {i}: wrong")
                out[f"{proto}_d{depth}"] = {
                    "ops": len(ops), "calls": len(lat),
                    "p50_us": _pct(lat, 0.5), "p99_us": _pct(lat, 0.99)}
    finally:
        clients.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--kv-ops", type=int, default=2000)
    args = ap.parse_args(argv)
    from .mini_memcached import MiniMemcached
    m = port_modules()
    server = start_server(m)
    mc = MiniMemcached().start()
    try:
        res = drive(m, server.listen_port, mc.port, calls=args.calls,
                    kv_ops=args.kv_ops)
    finally:
        mc.stop()
        server.stop()
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
