"""nshead, nova_pbrpc, public_pbrpc, hulu_pbrpc, sofa_pbrpc and esp on both
packages: every test of ``tests/test_legacy_protocols.py`` over
``brpc_tpu`` and over ``brpc_tpu_torch``, then seeded nshead and esp heads
and hulu, sofa, nova and public_pbrpc frames that must be the same bytes
in both packages and parse to equal values.  Each package against the
other over TCP is in ``tests/test_torch_protocols.py``.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu.butil.iobuf import IOBuf as JBuf
from brpc_tpu.policy import (esp as jesp, legacy_pbrpc as jlegacy,
                             nova as jnova, nshead as jnshead,
                             public_pbrpc as jpublic)
from brpc_tpu.rpc.controller import Controller as JCntl
from brpc_tpu_torch.butil.iobuf import IOBuf as TBuf
from brpc_tpu_torch.policy import (esp as tesp, legacy_pbrpc as tlegacy,
                                   nova as tnova, nshead as tnshead,
                                   public_pbrpc as tpublic)
from brpc_tpu_torch.rpc.controller import Controller as TCntl
from tests import torch_mirror
from tests.echo_pb2 import EchoRequest
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_legacy_protocols.py", globals())

JAX = types.SimpleNamespace(Buf=JBuf, Cntl=JCntl, legacy=jlegacy,
                            nova=jnova, nshead=jnshead, public=jpublic,
                            esp=jesp)
PORT = types.SimpleNamespace(Buf=TBuf, Cntl=TCntl, legacy=tlegacy,
                             nova=tnova, nshead=tnshead, public=tpublic,
                             esp=tesp)


def _u(rng, bits):
    return int(rng.integers(0, 1 << bits, dtype=np.uint64))


@pytest.mark.parametrize("seed", range(6))
def test_seeded_nshead_and_esp_heads(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        f = dict(id=_u(rng, 16), version=_u(rng, 16), log_id=_u(rng, 32),
                 provider=bytes(rng.integers(1, 256, rng.integers(0, 17),
                                             dtype=np.uint8)),
                 reserved=_u(rng, 32), body_len=_u(rng, 31))
        jb = jnshead.NsheadHead(**f).pack()
        tb = tnshead.NsheadHead(**f).pack()
        assert tb == jb
        assert tnshead.NsheadHead.unpack(tb) == \
            tnshead.NsheadHead(**{**f, "provider": f["provider"].rstrip(
                b"\x00")})
        assert vars(tnshead.NsheadHead.unpack(tb)) == \
            vars(jnshead.NsheadHead.unpack(jb))
        e = dict(from_addr=_u(rng, 63), to_addr=_u(rng, 63),
                 msg=_u(rng, 32), msg_id=_u(rng, 63), body_len=_u(rng, 24))
        assert tesp.EspHead(**e).pack() == jesp.EspHead(**e).pack()
        assert vars(tesp.EspHead.unpack(tesp.EspHead(**e).pack())) == e


def _cntl(pkg, rng):
    cntl = pkg.Cntl()
    cntl.log_id = _u(rng, 40)
    cntl.compress_type = int(rng.integers(0, 3))
    cntl.method_index = int(rng.integers(0, 4))
    return cntl


def _frames(pkg, seed):
    """The request frames each protocol packs for one seeded call."""
    rng = np.random.default_rng(seed)
    req = EchoRequest(message="m%d" % rng.integers(0, 1 << 20),
                      sleep_us=int(rng.integers(0, 1000)))
    cid = _u(rng, 40)
    out = {}
    for name, pack in (("hulu", pkg.legacy.hulu_pack_request),
                       ("sofa", pkg.legacy.sofa_pack_request),
                       ("nova", pkg.nova.pack_request),
                       ("public", pkg.public.pack_request)):
        cntl = _cntl(pkg, np.random.default_rng([seed, 1]))
        payload = pkg.legacy._serialize_pb(req, cntl)
        out[name] = pack(payload, cid, cntl,
                         "EchoService.Echo").to_bytes()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_seeded_hulu_sofa_nova_public_frames(seed):
    jf, tf = _frames(JAX, seed), _frames(PORT, seed)
    assert tf == jf
    # and each parses alike: the hulu and sofa metas field for field
    for pkg, frames in ((JAX, jf), (PORT, tf)):
        hulu = pkg.legacy.hulu_parse(pkg.Buf(frames["hulu"]), None, False,
                                     None)
        sofa = pkg.legacy.sofa_parse(pkg.Buf(frames["sofa"]), None, False,
                                     None)
        pkg.parsed = (hulu.message.meta, hulu.message.body.to_bytes(),
                      sofa.message.meta.SerializeToString(),
                      sofa.message.body.to_bytes())
    assert PORT.parsed == JAX.parsed


@pytest.mark.parametrize("seed", range(4))
def test_seeded_response_metas(seed):
    """The servers' hulu and sofa response metas, built from seeded
    values, serialize alike (the packages' own generated classes)."""
    rng = np.random.default_rng(seed)
    vals = dict(error_code=int(rng.integers(0, 3000)),
                error_text="e%d" % rng.integers(0, 99),
                correlation_id=_u(rng, 40),
                compress_type=int(rng.integers(0, 3)))
    from brpc_tpu.proto import legacy_meta_pb2 as jpb
    from brpc_tpu_torch.proto import legacy_meta_pb2 as tpb
    assert tpb.HuluResponseMeta(**vals).SerializeToString() == \
        jpb.HuluResponseMeta(**vals).SerializeToString()
    sofa = dict(type=1, sequence_id=vals["correlation_id"], failed=True,
                error_code=vals["error_code"], reason=vals["error_text"])
    assert tpb.SofaRpcMeta(**sofa).SerializeToString() == \
        jpb.SofaRpcMeta(**sofa).SerializeToString()
