"""debug_sync on both packages: every test of ``tests/test_debug_sync.py``
over ``brpc_tpu`` and over ``brpc_tpu_torch`` (``tests/torch_mirror.py``),
with the port's wired locks checked by name and its layer driven through
real traffic.

Swaps in the port's copy:
- ``test_revive_callbacks_snapshot_under_registry_lock``: the port's
  ``start_health_check`` keys a revival callback by its code object and
  has no ``revive_key`` argument, so the registrars pass the callback
  alone (every insert still runs under ``_tasks_lock`` while the test
  snapshots ``_revive_cbs`` under it).
- ``test_device_plane_counters_exact_under_contention``: the port's plane
  has no program cache, so the contended pair is its own two counters
  under ``DevicePlane._lock``, ``kernel_builds`` and ``build_failures``
  (``stats()``'s keys of the same names).
- ``test_fabric_bulk_counters_exact_under_contention``: the port's bulk
  library exports ``brpc_tpu_torch_fab_send``.

The JAX file's module fixture ``instrumented`` is set on each package's
``TestDebugSync`` class, bound to that copy's ``debug_sync`` and flags.

Mapped, not mirrored:
- ``TestSweepFixRegressions::test_xfer_connection_dials_outside_lock``
  holds ``FabricNode.xfer_connection``, the JAX node's cache of
  transfer-server connections under ``FabricNode._xfer_lock``.  The
  port's kind 1 pulls a staged row through ``ici/ipc_pull.py`` (a CUDA
  IPC mapping, a shared-memory segment on the CPU) and dials no transfer
  server, so neither the cache nor its lock exists.  The contract it
  guards, no dial under a node lock, is held for the port's one dial by
  fablint's blocking-under-lock rule over ``brpc_tpu_torch/ici/fabric.py``
  (``tests/test_torch_fablint.py``'s package gates).
"""
from __future__ import annotations

import sys

import pytest

from tests import torch_mirror

torch_mirror.mirror("tests/test_debug_sync.py", globals(), swaps=[
    ("""                    hc.start_health_check(
                        ep, on_revived=lambda _ep: None,
                        revive_key=(i, n % 7))""",
     """                    hc.start_health_check(
                        ep, on_revived=lambda _ep: None)"""),
    ("plane.cache_hits += 1", "plane.kernel_builds += 1"),
    ("plane.fallbacks += 1", "plane.build_failures += 1"),
    ('plane.stats()["program_cache_hits"]', 'plane.stats()["kernel_builds"]'),
    ('plane.stats()["fallbacks"]', 'plane.stats()["build_failures"]'),
    ("def brpc_tpu_fab_send(", "def brpc_tpu_torch_fab_send("),
])

# the JAX node's transfer-server cache has no port counterpart (above)
TestSweepFixRegressionsPort.test_xfer_connection_dials_outside_lock = None  # noqa: F821


def _instrumented_fixture(mod):
    """The JAX file's module fixture ``instrumented`` for one package's
    copy (a mirrored class looks its fixtures up on itself): the layer on
    for the test, its graph reset around it."""
    @pytest.fixture()
    def instrumented(self):
        dbg, fl = mod.debug_sync, mod._flags
        old = fl.get_flag("debug_lock_order")
        fl.set_flag("debug_lock_order", True)
        dbg.reset()
        yield
        fl.set_flag("debug_lock_order", old)
        dbg.reset()
    return instrumented


TestDebugSyncJax.instrumented = _instrumented_fixture(  # noqa: F821
    sys.modules["tests._mirror_jax_test_debug_sync"])
TestDebugSyncPort.instrumented = _instrumented_fixture(  # noqa: F821
    sys.modules["tests._mirror_port_test_debug_sync"])


def test_port_locks_carry_the_reference_names():
    """With the layer on, the port's hot objects build DebugLocks under
    the reference's names: a socket, a stream, a KV pool, the device
    plane's transfer table and the balancers."""
    import torch
    from brpc_tpu_torch.butil import debug_sync, flags
    from brpc_tpu_torch.ici.device_plane import DevicePlane
    from brpc_tpu_torch.policy import load_balancers as lb
    from brpc_tpu_torch.rpc.stream import Stream, StreamOptions
    from brpc_tpu_torch.serving import KvPoolOptions, PagedKvPool
    old = flags.get_flag("debug_lock_order")
    flags.set_flag("debug_lock_order", True)
    debug_sync.reset()
    try:
        plane = DevicePlane()
        st = Stream(StreamOptions(), is_client=True)
        pool = PagedKvPool(KvPoolOptions(bytes_per_token=8, num_blocks=4,
                                         block_tokens=4), device="cpu")
        rr = lb.RoundRobinLB()
        names = {plane._lock.name, st._flow_lock.name, st._state_lock.name,
                 st._wire_lock.name, pool._lock.name,
                 pool._counters_lock.name, rr._ilock.name}
        assert names == {"DevicePlane._lock", "Stream._flow_lock",
                         "Stream._state_lock", "Stream._wire_lock",
                         "PagedKvPool._lock", "PagedKvPool._counters_lock",
                         "RoundRobinLB._ilock"}
        rows = torch.arange(8 * 6, dtype=torch.uint8).view(6, 8)
        pool.load("s", rows, last_token=1)
        assert pool.pin("s")
        pool.unpin("s")
        pool.close()
        rep = debug_sync.report()
        assert rep["ok"], rep
    finally:
        flags.set_flag("debug_lock_order", old)
        debug_sync.reset()
