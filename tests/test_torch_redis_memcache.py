"""Redis (RESP) and memcache (binary) on both packages: every test of
``tests/test_redis_memcache.py`` and the redis and memcache classes of
``tests/test_wire_fixtures.py`` over ``brpc_tpu`` and over
``brpc_tpu_torch``; seeded commands, replies and memcache ops encode to
the same bytes in both and decode to equal values.  Each package against
the other over TCP (redis pipelining 16 commands in one call) is in
``tests/test_torch_protocols.py``.
"""
from __future__ import annotations

import struct
import types

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu.butil.iobuf import IOBuf as JBuf
from brpc_tpu.policy import memcache as jmc
from brpc_tpu.policy import redis as jredis
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf
from brpc_tpu_torch.policy import memcache as tmc
from brpc_tpu_torch.policy import redis as tredis
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_redis_memcache.py", globals())


torch_mirror.mirror("tests/test_wire_fixtures.py", globals(),
                   names=["TestRedisResp", "TestMemcacheBinary"],
                   prefix="Wire")


# ---- seeded encodings ------------------------------------------------

def _seeded_args(rng, n):
    out = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            out.append(bytes(rng.integers(0, 256, rng.integers(0, 40),
                                          dtype=np.uint8)))
        elif kind == 1:
            out.append(int(rng.integers(-1 << 40, 1 << 40)))
        else:
            out.append("k%d" % rng.integers(0, 1 << 30))
    return out


def _seeded_value(rng, depth=0):
    kind = rng.integers(0, 6 if depth < 2 else 4)
    if kind == 0:
        return None
    if kind == 1:
        return int(rng.integers(-1 << 40, 1 << 40))
    if kind == 2:
        return bytes(rng.integers(0, 256, rng.integers(0, 32),
                                  dtype=np.uint8))
    if kind == 3:
        return "s%d" % rng.integers(0, 1000)
    if kind == 4:
        return [_seeded_value(rng, depth + 1)
                for _ in range(rng.integers(0, 5))]
    return ("status", "OK%d" % rng.integers(0, 9))


def _as_reply(mod, v):
    if isinstance(v, tuple):
        return mod.RedisReply(mod.REPLY_STATUS, v[1])
    if isinstance(v, list):
        return [_as_reply(mod, x) for x in v]
    return v


def _reply_tree(r):
    if isinstance(r.value, list):
        return (r.type, [_reply_tree(x) for x in r.value])
    return (r.type, r.value)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_resp_commands_and_replies_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        args = ["SET"] + _seeded_args(rng, int(rng.integers(0, 6)))
        assert tredis.encode_command(*args) == jredis.encode_command(*args)
        v = _seeded_value(rng)
        jb = jredis.encode_reply(_as_reply(jredis, v))
        tb = tredis.encode_reply(_as_reply(tredis, v))
        assert tb == jb
        jr, jn = jredis._parse_one(jb, 0)
        tr, tn = tredis._parse_one(tb, 0)
        assert jn == tn == len(jb)
        assert _reply_tree(tr) == _reply_tree(jr)


def _seeded_memcache_ops(mod, rng):
    req = mod.MemcacheRequest()
    for i in range(int(rng.integers(1, 12))):
        key = "k%d" % rng.integers(0, 50)
        op = int(rng.integers(0, 7))
        if op == 0:
            req.set(key, bytes(rng.integers(0, 256, rng.integers(0, 64),
                                            dtype=np.uint8)),
                    flags=int(rng.integers(0, 1 << 31)),
                    exptime=int(rng.integers(0, 1000)))
        elif op == 1:
            req.get(key)
        elif op == 2:
            req.delete(key)
        elif op == 3:
            req.incr(key, int(rng.integers(0, 100)),
                     initial=int(rng.integers(0, 100)))
        elif op == 4:
            req.decr(key, int(rng.integers(0, 100)))
        elif op == 5:
            req.add(key, b"v%d" % i)
        else:
            req.version()
    return req


@pytest.mark.parametrize("seed", range(6))
def test_seeded_memcache_ops_match(seed):
    jreq = _seeded_memcache_ops(jmc, np.random.default_rng(seed))
    treq = _seeded_memcache_ops(tmc, np.random.default_rng(seed))
    assert treq.serialize() == jreq.serialize()
    assert treq.op_count() == jreq.op_count()
    # a response stream for those ops decodes alike in both
    rng = np.random.default_rng(seed + 100)
    frames = b""
    for i in range(jreq.op_count()):
        val = bytes(rng.integers(0, 256, rng.integers(0, 40),
                                 dtype=np.uint8))
        extras = struct.pack(">I", int(rng.integers(0, 1 << 31)))
        frames += jmc._HDR.pack(jmc.MAGIC_RESPONSE, jmc.OP_GET, 0,
                                len(extras), 0, int(rng.integers(0, 2)),
                                len(extras) + len(val), i, 0) + extras + val
    jops = _cut_responses(jmc, JBuf, frames)
    tops = _cut_responses(tmc, TBuf, frames)
    assert len(tops) == jreq.op_count()
    assert [(o.opcode, o.status, o.value, o.cas, o.flags) for o in tops] \
        == [(o.opcode, o.status, o.value, o.cas, o.flags) for o in jops]


def _cut_responses(mod, buf_cls, frames):
    """A client's parse of ``frames`` (a call is outstanding)."""
    sock = types.SimpleNamespace(pipelined_contexts=[object()])
    src = buf_cls(frames)
    result = mod.parse(src, sock, False, types.SimpleNamespace(server=None))
    assert len(src) == 0
    return list(result.message)
