"""Mongo (BSON, OP_MSG) on both packages: every test of
``tests/test_mongo.py`` and the mongo class of
``tests/test_wire_fixtures.py`` over ``brpc_tpu`` and over
``brpc_tpu_torch``, then seeded BSON documents that must encode to the
same bytes in both packages and decode to equal values, and the
request-id table's TTL sweep.  Each package against the other over TCP is
in ``tests/test_torch_protocols.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu.policy import mongo as jmongo
from brpc_tpu_torch.policy import mongo as tmongo
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_mongo.py", globals())
torch_mirror.mirror("tests/test_wire_fixtures.py", globals(),
                   names=["TestMongoBson"], prefix="Wire")


def _seeded_value(rng, depth):
    kind = int(rng.integers(0, 9 if depth < 3 else 7))
    if kind == 0:
        return int(rng.integers(-1 << 31, 1 << 31))
    if kind == 1:
        return int(rng.integers(-1 << 62, 1 << 62))
    if kind == 2:
        return float(rng.standard_normal())
    if kind == 3:
        return "s%d" % rng.integers(0, 1 << 20)
    if kind == 4:
        return bool(rng.integers(0, 2))
    if kind == 5:
        return None
    if kind == 6:
        return bytes(rng.integers(0, 256, rng.integers(0, 16),
                                  dtype=np.uint8))
    if kind == 7:
        return _seeded_doc(rng, depth + 1)
    return [_seeded_value(rng, depth + 1)
            for _ in range(int(rng.integers(0, 4)))]


def _seeded_doc(rng, depth=0):
    return {"k%d" % i: _seeded_value(rng, depth)
            for i in range(int(rng.integers(0, 6)))}


@pytest.mark.parametrize("seed", range(8))
def test_seeded_bson_documents_encode_alike(seed):
    doc = _seeded_doc(np.random.default_rng(seed))
    jb = jmongo.bson_encode(doc)
    tb = tmongo.bson_encode(doc)
    assert tb == jb
    assert tmongo.bson_decode(tb) == jmongo.bson_decode(jb) == doc
    assert tmongo._pack_op_msg(doc) == jmongo._pack_op_msg(doc)
    head = (len(tb) + tmongo.HEAD_SIZE, seed, 7, tmongo.OP_MSG)
    assert tmongo.MongoHead(*head).pack() == jmongo.MongoHead(*head).pack()


def test_request_id_table_sweeps_expired_entries():
    """A call whose reply never came leaves its request id behind only
    until its TTL: the sweep every ``_SWEEP_EVERY`` ids drops it, in the
    port as in the JAX package."""
    for mod in (jmongo, tmongo):
        rid = mod._new_request_id(12345, ttl=-1.0)   # expired at once
        for i in range(mod._SWEEP_EVERY):
            mod._take_cid(mod._new_request_id(i))
        assert mod._take_cid(rid) is None
        live = mod._new_request_id(777)
        assert mod._take_cid(live) == 777
