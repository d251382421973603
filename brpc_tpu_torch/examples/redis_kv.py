"""A redis server and client with AUTH (example/redis_c++: the framework as
both a redis-speaking client and a RedisService server).  The channel's
RedisAuthenticator sends AUTH once on its connection; then one pipeline
sets, gets and deletes a key.

    python -m brpc_tpu_torch.examples.redis_kv            # card
    python -m brpc_tpu_torch.examples.redis_kv --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import parse_device, setup_mesh
from brpc_tpu_torch.policy import redis as redis_proto
from brpc_tpu_torch.policy.auth import RedisAuthenticator

PASSWORD = "open-sesame"


def make_service() -> redis_proto.RedisService:
    svc = redis_proto.RedisService()
    data = {}

    def ok():
        return redis_proto.RedisReply(redis_proto.REPLY_STATUS, "OK")

    def auth(args):
        if bytes(args[0]).decode() == PASSWORD:
            return ok()
        return redis_proto.RedisReply(redis_proto.REPLY_ERROR, "ERR denied")

    def set_(args):
        data[bytes(args[0])] = bytes(args[1])
        return ok()

    svc.add_handler("AUTH", auth)
    svc.add_handler("SET", set_)
    svc.add_handler("GET", lambda args: data.get(bytes(args[0])))
    svc.add_handler("DEL", lambda args: int(
        data.pop(bytes(args[0]), None) is not None))
    return svc


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = rpc.Server()
    server.add_service(make_service())
    ch = rpc.Channel()
    try:
        if server.start("mem://redis-example") != 0:
            return 1
        ch.init("mem://redis-example", options=rpc.ChannelOptions(
            protocol="redis", timeout_ms=2000,
            auth=RedisAuthenticator(PASSWORD)))
        req = redis_proto.RedisRequest()
        req.add_command("SET", "fabric", "tpu")
        req.add_command("GET", "fabric")
        req.add_command("DEL", "fabric")
        cntl = rpc.Controller()
        resp = ch.call_method("redis", cntl, req, None)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        values = [r.value for r in resp.replies]
        print("redis pipeline ->", values)
        return 0 if values == ["OK", b"tpu", 1] else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
