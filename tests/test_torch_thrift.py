"""Thrift (framed TBinaryProtocol) on both packages: every test of
``tests/test_thrift.py`` and the thrift class of
``tests/test_wire_fixtures.py`` over ``brpc_tpu`` and over
``brpc_tpu_torch``, then seeded structs with maps, lists and nested
structs that must encode to the same bytes in both packages and decode to
equal values.  Each package against the other over TCP is in
``tests/test_torch_protocols.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu.policy import thrift as jthrift
from brpc_tpu_torch.policy import thrift as tthrift
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_thrift.py", globals())
torch_mirror.mirror("tests/test_wire_fixtures.py", globals(),
                   names=["TestThriftBinary"], prefix="Wire")

T = jthrift.TType
_SCALARS = [(T.BOOL, lambda r: bool(r.integers(0, 2))),
            (T.BYTE, lambda r: int(r.integers(-128, 128))),
            (T.I16, lambda r: int(r.integers(-1 << 15, 1 << 15))),
            (T.I32, lambda r: int(r.integers(-1 << 31, 1 << 31))),
            (T.I64, lambda r: int(r.integers(-1 << 62, 1 << 62))),
            (T.DOUBLE, lambda r: float(r.standard_normal())),
            (T.STRING, lambda r: bytes(r.integers(0, 256, r.integers(0, 24),
                                                  dtype=np.uint8)))]


def _seeded_spec(rng, depth=0):
    """A struct spec: scalars, a list, a string-keyed map of i32 and,
    above the last level, a nested struct and a map of structs."""
    spec = {}
    fid = 1
    for _ in range(int(rng.integers(1, 5))):
        spec[fid] = (f"f{fid}", _SCALARS[int(rng.integers(
            0, len(_SCALARS)))][0])
        fid += 1
    spec[fid] = (f"f{fid}", T.LIST, (_SCALARS[int(rng.integers(2, 5))][0],
                                     None))
    fid += 1
    spec[fid] = (f"f{fid}", T.MAP, ((T.STRING, None), (T.I32, None)))
    fid += 1
    if depth < 2:
        spec[fid] = (f"f{fid}", T.STRUCT, _seeded_spec(rng, depth + 1))
        fid += 1
        spec[fid] = (f"f{fid}", T.MAP, ((T.I32, None),
                                        (T.STRUCT, _seeded_spec(rng, 2))))
    return spec


def _seeded_values(rng, spec):
    gens = dict(_SCALARS)
    out = {}
    for _fid, field in spec.items():
        name, ttype = field[0], field[1]
        if ttype in gens:
            out[name] = gens[ttype](rng)
        elif ttype == T.LIST:
            gen = gens[field[2][0]]
            out[name] = [gen(rng) for _ in range(int(rng.integers(0, 6)))]
        elif ttype == T.STRUCT:
            out[name] = _seeded_values(rng, field[2])
        elif field[2][1][0] == T.STRUCT:
            out[name] = {i: _seeded_values(rng, field[2][1][1])
                         for i in range(int(rng.integers(0, 3)))}
        else:
            out[name] = {b"k%d" % i: int(rng.integers(-1000, 1000))
                         for i in range(int(rng.integers(0, 5)))}
    return out


def _encode(mod, spec, values):
    w = mod._Writer()
    mod.write_struct(w, values, spec)
    return w.getvalue()


@pytest.mark.parametrize("seed", range(8))
def test_seeded_structs_encode_alike(seed):
    rng = np.random.default_rng(seed)
    spec = _seeded_spec(rng)
    values = _seeded_values(rng, spec)
    jb = _encode(jthrift, spec, values)
    tb = _encode(tthrift, spec, values)
    assert tb == jb
    jv = jthrift.read_struct(jthrift._Reader(jb), spec)
    tv = tthrift.read_struct(tthrift._Reader(tb), spec)
    assert tv == jv
    # a whole call frame too
    assert tthrift.pack_message("M", tthrift.MSG_CALL, seed, tb) == \
        jthrift.pack_message("M", jthrift.MSG_CALL, seed, jb)
