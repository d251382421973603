"""tpu_std wire parity: the port's frames are byte-identical to the JAX
package's, and each side's parser reads the other's frames."""
import numpy as np
import pytest
import torch

from brpc_tpu.butil.iobuf import IOBuf as JaxIOBuf
from brpc_tpu.policy import tpu_std as jstd
from brpc_tpu.proto import rpc_meta_pb2 as jmeta
from brpc_tpu.rpc.controller import Controller as JaxController
from brpc_tpu.rpc.protocol import ParseResultType as JaxParse
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import tpu_std
from brpc_tpu_torch.proto import rpc_meta_pb2 as meta
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.protocol import ParseResultType


def _fill_meta(m, rng):
    m.correlation_id = int(rng.integers(1, 1 << 62))
    m.request.service_name = "EchoService"
    m.request.method_name = "Echo"
    m.request.log_id = int(rng.integers(0, 1 << 31))
    m.request.timeout_ms = int(rng.integers(1, 60000))
    m.request.deadline_left_ms = int(rng.integers(1, 60000))
    m.request.tenant = "t%d" % int(rng.integers(0, 100))
    m.response.error_code = int(rng.integers(0, 3000))
    m.response.error_text = "e%d" % int(rng.integers(0, 100))
    return m


def _bodies(seed):
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, int(rng.integers(0, 300)),
                        dtype=np.uint8).tobytes()
    att = rng.integers(0, 256, int(rng.integers(1, 5000)), dtype=np.uint8)
    return rng, body, att


@pytest.mark.parametrize("seed", range(4))
def test_pack_frame_is_byte_identical(seed):
    rng, body, att = _bodies(seed)
    m_port = _fill_meta(meta.RpcMeta(), np.random.default_rng(seed))
    m_jax = _fill_meta(jmeta.RpcMeta(), np.random.default_rng(seed))
    m_port.attachment_size = m_jax.attachment_size = len(att)
    p = IOBuf(body)
    p.append(att.tobytes())
    j = JaxIOBuf(body)
    j.append(att.tobytes())
    assert tpu_std.pack_frame(m_port, p).to_bytes() == \
        jstd.pack_frame(m_jax, j).to_bytes()


@pytest.mark.parametrize("seed", range(3))
def test_pack_request_with_device_attachment_is_byte_identical(seed):
    """The client's request frame, attachment in device memory on both
    sides (a JAX array on the CPU mesh, a torch tensor owned by a rank)."""
    import jax
    rng, body, att = _bodies(100 + seed)
    cid = int(rng.integers(1, 1 << 40))
    mesh = IciMesh(ranks=8, device="cpu")
    c_port, c_jax = Controller(), JaxController()
    for c in (c_port, c_jax):
        c.timeout_ms = 1500
        c.log_id = seed
    c_port.request_attachment.append_device_array(
        mesh.device_put(torch.from_numpy(att.copy()), 1))
    c_jax.request_attachment.append_device_array(
        jax.device_put(att, jax.devices()[1]))
    f_port = tpu_std.pack_request(IOBuf(body), cid, c_port,
                                  "EchoService.Echo").to_bytes()
    f_jax = jstd.pack_request(JaxIOBuf(body), cid, c_jax,
                              "EchoService.Echo").to_bytes()
    assert f_port == f_jax


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_parser_reads_the_other_sides_frame(direction):
    rng, body, att = _bodies(7)
    m_port = _fill_meta(meta.RpcMeta(), np.random.default_rng(7))
    m_jax = _fill_meta(jmeta.RpcMeta(), np.random.default_rng(7))
    m_port.attachment_size = m_jax.attachment_size = len(att)
    payload = body + att.tobytes()
    if direction == "jax_to_port":
        wire = jstd.pack_frame(m_jax, JaxIOBuf(payload)).to_bytes()
        src = IOBuf(wire + b"TR")       # a second frame's first bytes
        res = tpu_std.parse(src, None, False, None)
        assert res.type == ParseResultType.OK
        want = m_port
    else:
        wire = tpu_std.pack_frame(m_port, IOBuf(payload)).to_bytes()
        src = JaxIOBuf(wire + b"TR")
        res = jstd.parse(src, None, False, None)
        assert res.type == JaxParse.OK
        want = m_jax
    assert res.message.meta.SerializeToString() == want.SerializeToString()
    assert res.message.body.to_bytes() == payload
    assert src.to_bytes() == b"TR"      # the next frame is left in place


def test_parse_waits_for_whole_frame_and_refuses_foreign_bytes():
    m = meta.RpcMeta(correlation_id=9)
    wire = tpu_std.pack_frame(m, IOBuf(b"x" * 50)).to_bytes()
    assert tpu_std.parse(IOBuf(wire[:20]), None, False,
                         None).type == ParseResultType.NOT_ENOUGH_DATA
    assert tpu_std.parse(IOBuf(b"TR"), None, False,
                         None).type == ParseResultType.NOT_ENOUGH_DATA
    assert tpu_std.parse(IOBuf(b"GET / HTTP/1.1\r\n"), None, False,
                         None).type == ParseResultType.TRY_OTHERS
    absurd = b"TRPC" + (1 << 27).to_bytes(4, "big") + (0).to_bytes(4, "big")
    assert tpu_std.parse(IOBuf(absurd), None, False,
                         None).type == ParseResultType.ERROR


@pytest.mark.parametrize("priority,tenant", [(None, ""), (0, "gold"),
                                             (3, "t-7")])
def test_pack_request_with_request_context_is_byte_identical(priority,
                                                             tenant):
    """Priority (offset-encoded) and tenant ride RequestMeta as the JAX
    package writes them."""
    c_port, c_jax = Controller(), JaxController()
    for c in (c_port, c_jax):
        c.timeout_ms = 900
        c.priority = priority
        c.tenant = tenant
    f_port = tpu_std.pack_request(IOBuf(b"body"), 77, c_port,
                                  "Decode.Decode").to_bytes()
    f_jax = jstd.pack_request(JaxIOBuf(b"body"), 77, c_jax,
                              "Decode.Decode").to_bytes()
    assert f_port == f_jax
