"""The port's device plane (brpc_tpu_torch/ici/device_plane.py) and its
mesh of logical ranks, held against the JAX package's plane.

Mirrors tests/test_device_plane.py on a CPU mesh of 8 ranks: the QP
lifecycle (post_send → rendezvous → completion), the one-kernel
equivalent of the program cache, the match-timeout reaper, and the rule
that a failing copy fails the transfer instead of falling back.  Payloads
come from a numpy seed and go through both planes; bytes must agree
exactly.
"""
import gc
import time

import numpy as np
import pytest
import torch

from brpc_tpu.butil import flags as jfl
from brpc_tpu.ici import device_plane as jdp
from brpc_tpu.ici.mesh import IciMesh as JaxMesh
from brpc_tpu_torch.butil import flags as fl
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh


@pytest.fixture(scope="module", autouse=True)
def port_mesh():
    """A CPU mesh of 8 ranks as the port's default; at module teardown no
    transfer may still hold a pin."""
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    yield mesh
    IciMesh.set_default(None)
    assert dp.plane().active_transfers() == 0


@pytest.fixture()
def plane_on():
    names = ("ici_device_plane", "ici_device_plane_host_mesh",
             "ici_device_plane_threshold", "ici_device_plane_match_timeout_s")
    saved = {n: fl.get_flag(n) for n in names}
    jsaved = {n: jfl.get_flag(n) for n in names}
    for f in (fl, jfl):
        f.set_flag("ici_device_plane", True)
        f.set_flag("ici_device_plane_host_mesh", True)
        f.set_flag("ici_device_plane_threshold", 1024)
    yield dp.plane()
    for n, v in saved.items():
        fl.set_flag(n, v)
    for n, v in jsaved.items():
        jfl.set_flag(n, v)


def _seeded(nbytes, seed=0):
    return np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8)


def _payload(mesh, nbytes, rank, seed=0):
    return mesh.device_put(torch.from_numpy(_seeded(nbytes, seed)), rank)


class TestQPLifecycle:
    @pytest.mark.parametrize("nbytes,src,dst", [(8192, 2, 5), (65537, 1, 0),
                                                (1 << 20, 7, 3)])
    def test_rendezvous_moves_exact_bytes_onto_dst_rank(
            self, plane_on, port_mesh, nbytes, src, dst):
        import jax
        data = _seeded(nbytes, seed=nbytes)
        t = plane_on.post_send(_payload(port_mesh, nbytes, src, nbytes),
                               src, dst)
        assert t.state == dp.POSTED
        assert plane_on.pending_sends() >= 1
        assert plane_on.post_recv(t.uuid) is t      # both sides share the WR
        assert t.wait(30) == 0
        assert t.state == dp.COMPLETE
        assert port_mesh.rank_of(t.out) == dst      # owned by the dst rank
        # the JAX plane moves the same bytes between the same devices
        jplane = jdp.plane()
        jt = jplane.post_send(
            jax.device_put(data, JaxMesh.default().device(src)), src, dst)
        jplane.post_recv(jt.uuid)
        assert jt.wait(30) == 0
        np.testing.assert_array_equal(t.out.numpy(), np.asarray(jt.out))
        np.testing.assert_array_equal(t.out.numpy(), data)
        d = t.describe()
        assert d["posted_to_matched_us"] >= 0
        assert d["matched_to_complete_us"] >= 0

    def test_source_pin_releases_exactly_once_at_completion(
            self, plane_on, port_mesh):
        released = []
        t = plane_on.post_send(_payload(port_mesh, 4096, 1), 1, 3)
        t.add_source_release(lambda: released.append(1))
        assert released == []               # pinned while POSTED
        assert t.source_array() is not None
        plane_on.post_recv(t.uuid)
        assert t.wait(30) == 0
        assert released == [1]
        assert t.source_array() is None     # the pin is gone
        # registering after completion fires immediately, still once each
        t.add_source_release(lambda: released.append(2))
        assert released == [1, 2]

    def test_counters_match_the_jax_plane(self, plane_on, port_mesh):
        import jax
        jplane = jdp.plane()
        before, jbefore = plane_on.stats(), jplane.stats()
        t = plane_on.post_send(_payload(port_mesh, 2048, 0), 0, 4)
        plane_on.post_recv(t.uuid)
        assert t.wait(30) == 0
        jt = jplane.post_send(jax.device_put(_seeded(2048),
                                             JaxMesh.default().device(0)),
                              0, 4)
        jplane.post_recv(jt.uuid)
        assert jt.wait(30) == 0
        after, jafter = plane_on.stats(), jplane.stats()
        shared = {"transfers", "bytes_sent", "bytes_recv", "match_timeouts",
                  "pending_sends"}
        for key in shared - {"pending_sends"}:
            assert after[key] - before[key] == jafter[key] - jbefore[key], key
        assert after["transfers"] == before["transfers"] + 1
        assert after["bytes_sent"] == before["bytes_sent"] + 2048
        assert after["bytes_recv"] == before["bytes_recv"] + 2048
        # keys whose meaning holds keep the JAX name; the program cache
        # and its fallbacks have no counterpart in a one-kernel plane
        assert set(after) & set(jafter) == shared
        assert set(after) - shared == {"kernel_builds", "build_failures"}
        assert set(jafter) - shared == {"fallbacks", "program_cache_hits",
                                        "program_cache_misses"}

    def test_same_rank_post_is_refused(self, plane_on, port_mesh):
        with pytest.raises(dp.DevicePlaneError):
            plane_on.post_send(_payload(port_mesh, 2048, 3), 3, 3)

    def test_copy_failure_fails_the_transfer_without_fallback(
            self, plane_on, port_mesh, monkeypatch):
        """A copy that cannot run fails its transfer and raises: the pin
        releases, no bytes arrive, nothing falls back to another copy."""
        def broken(src, dst):
            raise RuntimeError("launch refused")
        monkeypatch.setattr(dp, "p2p_copy", broken)
        released = []
        t = plane_on.post_send(_payload(port_mesh, 2048, 1), 1, 2)
        t.add_source_release(lambda: released.append(1))
        with pytest.raises(RuntimeError, match="launch refused"):
            plane_on.post_recv(t.uuid)
        assert t.state == dp.FAILED
        assert t.wait(1) != 0
        assert t.out is None
        assert released == [1]
        assert plane_on.active_transfers() == 0


class TestOneKernelForEveryShape:
    def test_no_shape_or_route_builds_a_program(self, plane_on, port_mesh):
        """The JAX plane compiles one program per (size, route); the port
        runs one kernel for all.  On a CPU mesh nothing is built at all:
        five transfers, no build and no build failure."""
        s0 = plane_on.stats()
        for _ in range(4):
            t = plane_on.post_send(_payload(port_mesh, 3072, 1), 1, 2)
            plane_on.post_recv(t.uuid)
            assert t.wait(30) == 0
        t = plane_on.post_send(_payload(port_mesh, 5120, 6), 6, 2)
        plane_on.post_recv(t.uuid)
        assert t.wait(30) == 0
        s1 = plane_on.stats()
        assert s1["kernel_builds"] == s0["kernel_builds"]
        assert s1["build_failures"] == s0["build_failures"]
        assert s1["transfers"] == s0["transfers"] + 5


class TestFailureModes:
    def test_match_timeout_fails_only_that_transfer(self, plane_on,
                                                    port_mesh):
        fl.set_flag("ici_device_plane_match_timeout_s", 0.05)
        released = []
        orphan = plane_on.post_send(_payload(port_mesh, 2048, 1), 1, 7)
        orphan.add_source_release(lambda: released.append(1))
        time.sleep(0.1)
        timeouts0 = plane_on.stats()["match_timeouts"]
        plane_on._sweep_stale()
        assert orphan.state == dp.FAILED
        assert "match timeout" in orphan.error
        assert orphan.wait(1) != 0
        assert released == [1]
        assert plane_on.stats()["match_timeouts"] == timeouts0 + 1
        with pytest.raises(KeyError):
            plane_on.post_recv(orphan.uuid)   # reaped: rendezvous refused
        # an unrelated transfer is untouched
        fl.set_flag("ici_device_plane_match_timeout_s", 30.0)
        t = plane_on.post_send(_payload(port_mesh, 2048, 1), 1, 7)
        plane_on.post_recv(t.uuid)
        assert t.wait(30) == 0

    def test_ineligible_payloads_never_touch_the_plane(self, plane_on,
                                                       port_mesh):
        assert not dp.eligible(512, port_mesh, 1, 2)      # below threshold
        assert dp.eligible(1 << 20, port_mesh, 1, 2)
        fl.set_flag("ici_device_plane", False)
        assert not dp.eligible(1 << 20, port_mesh, 1, 2)  # switch off
        fl.set_flag("ici_device_plane", True)
        fl.set_flag("ici_device_plane_host_mesh", False)
        assert not dp.eligible(1 << 20, port_mesh, 1, 2)  # CPU mesh not opted in

    def test_ranks_on_different_devices_are_refused_before_posting(
            self, plane_on):
        """The kernel copies within one device; a pair of ranks on two
        devices is still eligible, so it reaches post_send, which refuses
        it before any descriptor exists (no library copy stands in)."""
        mesh = IciMesh(ranks=2, device="cpu")
        src = mesh.device_put(torch.arange(4096).to(torch.uint8), 0)
        mesh.devices = [torch.device("cpu"), torch.device("meta")]
        assert dp.eligible(4096, mesh, 0, 1)
        pending = plane_on.pending_sends()
        with pytest.raises(dp.DevicePlaneError, match="cross-card"):
            plane_on.post_send(src, 0, 1, mesh=mesh)
        assert plane_on.pending_sends() == pending


class TestMeshResidency:
    def test_ranks_share_one_device_but_keep_their_own_tensors(
            self, port_mesh):
        assert port_mesh.size == 8
        assert {str(port_mesh.device(k)) for k in range(8)} == {"cpu"}
        a = _payload(port_mesh, 64, 2)
        b = _payload(port_mesh, 64, 5)
        assert port_mesh.rank_of(a) == 2 and port_mesh.rank_of(b) == 5
        assert port_mesh.rank_of(torch.zeros(64, dtype=torch.uint8)) == -1

    def test_views_and_slices_resolve_to_the_owning_rank(self, port_mesh):
        t = _payload(port_mesh, 4096, 4)
        assert port_mesh.rank_of(t[100:200]) == 4
        assert port_mesh.rank_of(t[4095:]) == 4
        assert port_mesh.rank_of(t.view(64, 64)) == 4

    def test_entry_dies_with_its_storage(self, port_mesh):
        n0 = port_mesh.live_registrations()
        t = _payload(port_mesh, 128, 1)
        view = t[10:20]
        assert port_mesh.live_registrations() == n0 + 1
        del t
        gc.collect()
        assert port_mesh.rank_of(view) == 1      # the view keeps it alive
        del view
        gc.collect()
        assert port_mesh.live_registrations() == n0

    def test_device_put_passes_owned_tensors_by_reference(self, port_mesh):
        t = _payload(port_mesh, 256, 3)
        assert port_mesh.device_put(t, 3) is t
        moved = port_mesh.device_put(t, 6)
        assert moved is not t and moved.data_ptr() != t.data_ptr()
        assert port_mesh.rank_of(moved) == 6
        assert torch.equal(moved, t)

    def test_set_default_bumps_generation(self, port_mesh):
        g0 = IciMesh.generation
        IciMesh.set_default(port_mesh)
        assert IciMesh.generation == g0 + 1
        assert IciMesh.default() is port_mesh
