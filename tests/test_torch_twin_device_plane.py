"""``tests/test_device_plane.py`` on both packages
(``tests/torch_mirror.py``): the QP lifecycle, failure modes and socket
integration of the device plane that feeds the ``p2p_copy`` kernel.  The
port's copy runs on a CPU default mesh of 8 ranks (``cpu_mesh=True``),
with the plane's plain copy; the swaps are listed in
``tests/torch_array_swaps.py`` (``DEVICE_PLANE``).

Left out of the port's copy:
- ``TestProgramCache`` (2 cases): the JAX plane's compiled-program cache
  (one program per shape and route, counted in ``program_cache_misses``)
  and its Pallas remote-DMA program in interpret mode, picked by the flag
  ``ici_device_plane_kernel``.  The port has one hand-written kernel for
  every size and route and builds nothing per shape;
  ``tests/test_torch_device_plane.py::TestQPLifecycle::
  test_no_shape_or_route_builds_a_program`` holds that, and
  ``tests/test_torch_p2p_copy.py`` the kernel against its plain version.
- ``TestFailureModes::test_chaos_forced_post_failure_degrades_then_recovers``
  and ``TestSocketIntegration::
  test_chaos_refusal_falls_back_to_device_put_rpc_succeeds``: both read
  the JAX plane's ``fallbacks`` counter, which counts the refused posts
  its callers recovered from by moving the bytes with ``device_put``.
  The port has no such fallback: a refused post fails the write (no
  library copy stands in for the kernel), so the second case's RPC fails
  where the JAX one succeeds.  The refusal budget, the plane serving
  again mid-plan and after it, and the refused RPC failing are held on
  the port below (``test_refused_posts_then_recovery_port``,
  ``test_refused_post_fails_the_rpc_then_plane_serves_port``).

Repaired in the port by this suite: ``device_plane.eligible(nbytes)``
and ``platform_allows()`` take the JAX signatures (the mesh defaults to
the default mesh; the route was a required argument that decides
nothing).
"""
from __future__ import annotations

import sys

import numpy as np
import pytest

from tests import torch_array_swaps
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_device_plane.py", globals(),
                    swaps=torch_array_swaps.DEVICE_PLANE, cpu_mesh=True)

# the JAX program cache and the device_put fallback (above)
del TestProgramCachePort  # noqa: F821
TestFailureModesPort.test_chaos_forced_post_failure_degrades_then_recovers \
    = None  # noqa: F821
TestSocketIntegrationPort.\
    test_chaos_refusal_falls_back_to_device_put_rpc_succeeds = None  # noqa: F821


def _port():
    return sys.modules["tests._mirror_port_test_device_plane"]


@pytest.fixture()
def port_plane():
    """The port copy's ``plane_on`` on a fresh CPU default mesh."""
    mod = _port()
    with torch_mirror._isolated("brpc_tpu_torch", mod._mirror_own_flags,
                                cpu_mesh=True):
        gen = mod.plane_on.__wrapped__()
        plane = next(gen)
        yield mod, plane
        next(gen, None)


def test_refused_posts_then_recovery_port(port_plane):
    """Two refused posts raise before any descriptor exists and move
    nothing; with the budget spent the plane serves again mid-plan."""
    mod, plane = port_plane
    arr = mod._payload(2048, 3)
    t0 = plane.stats()["transfers"]
    with mod.fi.inject_fabric(
            mod.fi.FabricFaultPlan(device_plane_fail_posts=2)) as plan:
        for _ in range(2):
            with pytest.raises(mod.dp.DevicePlaneError):
                plane.post_send(arr, 3, 4)
        assert plane.stats()["transfers"] == t0
        t = plane.post_send(arr, 3, 4)
        plane.post_recv(t.uuid)
        assert t.wait(30) == 0
    assert plan.injected["device_plane"] == 2
    assert plane.stats()["transfers"] == t0 + 1
    np.testing.assert_array_equal(t.out.numpy(), arr.numpy())


def test_refused_post_fails_the_rpc_then_plane_serves_port(port_plane):
    """A refused post fails the call that needed it, with no copy made
    in its place; once the plan is gone the same route rides the plane."""
    mod, plane = port_plane
    case = mod.TestSocketIntegration()
    server = case._echo_server("ici://2")
    try:
        ch = mod.rpc.Channel()
        ch.init("ici://2", options=mod.rpc.ChannelOptions(
            timeout_ms=30000, max_retry=0))
        payload = mod._payload(8192, 3)
        t0 = plane.stats()["transfers"]
        with mod.fi.inject_fabric(
                mod.fi.FabricFaultPlan(device_plane_fail_posts=64)) as plan:
            cntl = mod.rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            ch.call_method("EchoService.Echo", cntl,
                           mod.EchoRequest(message="c"), mod.EchoResponse)
            assert cntl.failed()
        assert plan.injected["device_plane"] >= 1
        assert plane.stats()["transfers"] == t0
        cntl = mod.rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        resp = ch.call_method("EchoService.Echo", cntl,
                              mod.EchoRequest(message="r"), mod.EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "r"
        assert plane.stats()["transfers"] >= t0 + 2
        got = np.frombuffer(cntl.response_attachment.to_bytes(), np.uint8)
        np.testing.assert_array_equal(got, payload.numpy())
        ch.close()
    finally:
        server.stop()
