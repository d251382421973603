"""The authenticators and trackme on both packages.

Mirrored over ``brpc_tpu`` and ``brpc_tpu_torch`` (``tests/torch_mirror.py``):

- ``tests/test_auth_naming_extras.py``: ``TestRedisAuth`` (2),
  ``TestCouchbaseAuth`` (its 2 SASL tests and the esp magic) and
  ``TestTrackme`` (2);
- ``tests/test_auth_rpcz.py``: ``TestAuth`` (its 3 token tests and 2 HMAC
  ones; its ``TestRpcz`` is in ``tests/test_torch_observability.py``).

The one swap: the port's copy of ``test_auth_naming_extras.py`` takes
``KvRedis``, ``start_mini_memcached`` and ``unique`` from the port's copy
of ``tests/test_redis_memcache.py`` (``torch_mirror.load``), where the JAX
file imports the JAX module's.

Then the connection key over both packages: two redis channels with
different ``RedisAuthenticator``s to one server open two connections and
send two AUTHs (a connection authenticates once, before its first
command, so a shared one would carry only the first credential); the
authenticators' credentials and verdicts equal the JAX package's.
"""
from __future__ import annotations

import importlib

import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu.policy import auth as jauth
from brpc_tpu_torch.policy import auth as tauth
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror(
    "tests/test_auth_naming_extras.py", globals(),
    names=["TestRedisAuth", "TestCouchbaseAuth", "TestTrackme"],
    swaps=[("from tests.test_redis_memcache import (KvRedis, "
            "start_mini_memcached,\n                                       "
            "unique)",
            "from tests.torch_mirror import load as _load\n"
            "_rm = _load('tests/test_redis_memcache.py', True)\n"
            "KvRedis, start_mini_memcached, unique = (\n"
            "    _rm.KvRedis, _rm.start_mini_memcached, _rm.unique)")])

torch_mirror.mirror("tests/test_auth_rpcz.py", globals(), names=["TestAuth"])


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    root = "brpc_tpu" if request.param == "jax" else "brpc_tpu_torch"
    return (importlib.import_module(root + ".rpc"),
            importlib.import_module(root + ".policy.redis"),
            importlib.import_module(root + ".policy.auth"))


def test_two_redis_credentials_two_connections(pkg):
    rpc, redis, auth = pkg

    class Recorder(redis.RedisService):
        def __init__(self):
            super().__init__()
            self.auth_attempts = []
            self.add_handler("AUTH", self._auth)
            self.add_handler("PING", lambda args: redis.RedisReply(
                redis.REPLY_STATUS, "PONG"))

        def _auth(self, args):
            self.auth_attempts.append(bytes(args[0]))
            return redis.RedisReply(redis.REPLY_STATUS, "OK")

    svc = Recorder()
    server = rpc.Server()
    server.add_service(svc)
    assert server.start("127.0.0.1:0") == 0
    target = f"127.0.0.1:{server.listen_port}"
    chans = []
    try:
        for password in ("a", "b"):
            ch = rpc.Channel()
            ch.init(target, options=rpc.ChannelOptions(
                protocol="redis", timeout_ms=5000,
                auth=auth.RedisAuthenticator(password)))
            chans.append(ch)
        for _ in range(2):
            for ch in chans:
                cntl = rpc.Controller()
                resp = ch.call_method("redis", cntl, ("PING",), None)
                assert not cntl.failed(), cntl.error_text
                assert resp.reply(0).value == "PONG"
        assert svc.auth_attempts == [b"a", b"b"]
        ep = chans[0]._endpoint
        assert rpc.SocketMap.instance().stats()[ep] == 2
    finally:
        for ch in chans:
            ch.close()
        server.stop()


@pytest.mark.parametrize("make", [
    lambda m: m.TokenAuthenticator("s3cret"),
    lambda m: m.RedisAuthenticator("pw"),
    lambda m: m.RedisAuthenticator("pw with space", user="alice"),
    lambda m: m.CouchbaseAuthenticator("bucket", "pw"),
    lambda m: m.EspAuthenticator(),
])
def test_credentials_and_verdicts_equal_jax(make):
    j, t = make(jauth), make(tauth)
    cred = t.generate_credential(None)
    assert cred == j.generate_credential(None)
    for token in (cred, cred + "x", "", "s3cret", "pw", "bucket:pw"):
        assert t.verify(token, None) == j.verify(token, None), token
