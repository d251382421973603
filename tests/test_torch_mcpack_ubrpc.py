"""ubrpc over nshead with mcpack2 and compack bodies, and the mcpack codec,
on both packages: every test of ``tests/test_mcpack_ubrpc.py`` over
``brpc_tpu`` and over ``brpc_tpu_torch`` (the generator half through the
port's own ``brpc_tpu_torch.tools.mcpack2py``), then seeded objects that
must encode to the same mcpack and compack bytes in both packages and
decode to equal values, and ubrpc request frames byte for byte.  Each
package against the other over TCP is in ``tests/test_torch_protocols.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu.codec import mcpack as jmc
from brpc_tpu.policy import ubrpc as jub
from brpc_tpu.rpc.controller import Controller as JCntl
from brpc_tpu_torch.codec import mcpack as tmc
from brpc_tpu_torch.policy import ubrpc as tub
from brpc_tpu_torch.rpc.controller import Controller as TCntl
from tests import torch_mirror
from tests.echo_pb2 import EchoRequest, TagBag
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_mcpack_ubrpc.py", globals(), swaps=[
    ("from mcpack2py import generate_module_source",
     "from brpc_tpu_torch.tools.mcpack2py import generate_module_source"),
    ('[_sys.executable, "tools/mcpack2py.py",',
     '[_sys.executable, "-m", "brpc_tpu_torch.tools.mcpack2py",'),
])

# integers that land on every width the encoder picks
_INT_EDGES = [0, 1, 127, 128, -128, -129, 32767, 32768, -32768, -32769,
              (1 << 31) - 1, 1 << 31, -(1 << 31), -(1 << 31) - 1,
              (1 << 63) - 1, 1 << 63, (1 << 64) - 1, -(1 << 63)]


def _value(rng, depth):
    kind = int(rng.integers(0, 11 if depth < 3 else 7))
    if kind == 0:
        return int(rng.choice(_INT_EDGES))
    if kind == 1:
        return int(rng.integers(-1 << 40, 1 << 40))
    if kind == 2:
        return float(rng.standard_normal())
    if kind == 3:
        return "s" * int(rng.integers(0, 300))     # short and long heads
    if kind == 4:
        return bytes(rng.integers(0, 256, rng.integers(0, 300),
                                  dtype=np.uint8))
    if kind == 5:
        return bool(rng.integers(0, 2))
    if kind == 6:
        return None
    if kind == 7:         # an isoarray under compack: one int width
        return [int(rng.integers(-100, 100))
                for _ in range(int(rng.integers(1, 6)))]
    if kind == 8:
        return [float(rng.standard_normal())
                for _ in range(int(rng.integers(1, 4)))]
    if kind == 9:
        return [_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))]
    return _object(rng, depth + 1)


def _object(rng, depth=0):
    return {"k%d" % i: _value(rng, depth)
            for i in range(int(rng.integers(0, 6)))}


@pytest.mark.parametrize("compack", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_objects_encode_alike(seed, compack):
    obj = _object(np.random.default_rng(seed))
    jb = jmc.mcpack_encode(obj, compack=compack)
    tb = tmc.mcpack_encode(obj, compack=compack)
    assert tb == jb
    assert tmc.mcpack_decode(tb) == jmc.mcpack_decode(jb)


@pytest.mark.parametrize("compack", [False, True])
def test_seeded_pb_bridge_alike(compack):
    """The protobuf bridge (HasField semantics, maps, repeated) gives the
    same bytes in both packages."""
    rng = np.random.default_rng(3)
    for i in range(10):
        m = TagBag()
        for j in range(int(rng.integers(0, 4))):
            m.counts["c%d" % j] = int(rng.integers(-1 << 31, 1 << 31))
        m.ids.extend(int(x) for x in rng.integers(0, 1 << 40,
                                                  rng.integers(0, 5)))
        if i % 2:
            m.nested["n"].message = "deep%d" % i
        assert tmc.pb_to_mcpack(m, compack=compack) == \
            jmc.pb_to_mcpack(m, compack=compack)
        back = tmc.mcpack_to_pb(tmc.pb_to_mcpack(m, compack=compack),
                                TagBag())
        assert back == m


@pytest.mark.parametrize("seed", range(4))
def test_seeded_ubrpc_frames(seed):
    rng = np.random.default_rng(seed)
    req = EchoRequest(message="u%d" % rng.integers(0, 1 << 20),
                      sleep_us=int(rng.integers(0, 1000)))
    cid = int(rng.integers(1, 1 << 40))
    frames = []
    for mod, cntl_cls in ((jub, JCntl), (tub, TCntl)):
        cntl = cntl_cls()
        cntl.log_id = seed
        payload = mod.serialize_request(req, cntl)
        frames.append((mod.pack_request(payload, cid, cntl,
                                        "EchoService.Echo").to_bytes(),
                       mod.pack_request_compack(payload, cid, cntl,
                                                "EchoService.Echo")
                       .to_bytes()))
    assert frames[1] == frames[0]
