"""``tests/test_usercode_pool.py`` on both packages
(``tests/torch_mirror.py``).

Swaps in the port's copy: ``IciMesh(jax.devices())``, the JAX CPU
platform's 8 devices, is the port's 8-rank CPU mesh
(``IciMesh(8, device="cpu")``), and the port's copy runs on such a
default mesh (``cpu_mesh=True``).

Left out of the port's copy:
``TestIsolatedRpcDispatch::test_isolated_method_end_to_end`` places its
DEVICE attachment with ``jax.device_put(x, mesh.device(5))``; on the
port every rank may share one card, so a tensor's rank is recorded by
``mesh.device_put(x, 5)`` instead, which no allowed swap reaches.  The
same case with the port's spelling is
``test_isolated_method_end_to_end_port_placement`` below.
"""
from __future__ import annotations

import gc
import sys

import torch

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_usercode_pool.py", globals(), swaps=[
    ("IciMesh(jax.devices())", 'IciMesh(8, device="cpu")'),
], cpu_mesh=True)

# jax.device_put placement (above)
TestIsolatedRpcDispatchPort.test_isolated_method_end_to_end = None  # noqa: F821


def test_isolated_method_end_to_end_port_placement():
    """An isolated method answers over the native ``ici://`` plane with a
    256-byte DEVICE attachment owned by rank 5, handed through in the
    echo shape; the native registries drain after."""
    mod = sys.modules["tests._mirror_port_test_usercode_pool"]
    from brpc_tpu_torch.ici import native_plane
    from brpc_tpu_torch.ici.mesh import IciMesh
    before = IciMesh._default
    case = mod.TestIsolatedRpcDispatch()
    try:
        mesh, srv, ch = case._serve()
        try:
            payload = mesh.device_put(torch.arange(256, dtype=torch.uint8),
                                      5)
            for i in range(4):
                cntl = mod.rpc.Controller()
                cntl.request_attachment.append_device_array(payload)
                resp = ch.call_method("IsoService.Echo", cntl,
                                      mod.EchoRequest(message=f"m{i}"),
                                      mod.EchoResponse)
                assert not cntl.failed(), cntl.error_text
                assert resp.message == f"iso:m{i}"
                assert len(cntl.response_attachment) == 256
            del cntl, resp
            gc.collect()
            assert native_plane.registry().live() == 0
            assert native_plane.att_table_live() == 0
        finally:
            srv.stop()
            ch.close()
    finally:
        IciMesh.set_default(before)
