"""``tests/test_serving.py``'s scheduler, migration and service classes on
both packages (``tests/torch_mirror.py``): ``TestKvMigration``,
``TestContinuousBatchScheduler``, ``TestServingServices`` and
``TestAutoscaler``.  The pool classes are in
``tests/test_torch_twin_serving_pool.py``; the swaps are listed in
``tests/torch_serving_swaps.py``.

Left out of the port's copy:
- ``TestKvMigration::test_migrate_out_cutover_then_release``,
  ``test_transfer_deadline_latches_and_revives``,
  ``test_scheduler_fence_refuses_decoding_session`` and
  ``test_spilled_session_migrates_via_restore``: the test's sender reads
  the payload with ``np.frombuffer(payload, np.uint8)``; the port's
  ``migrate_out`` hands the sender the token-major rows as a tensor on
  the pool's device (the disaggregated example ships it as a DEVICE
  attachment, with no host copy), which numpy cannot read as a buffer.
  ``tests/test_torch_migration.py`` holds the cutover order, the
  transfer-deadline latch, the scheduler fence and the spilled session's
  restore on the port.
- ``TestContinuousBatchScheduler::test_compiled_step_parity``: the
  compiled step (flag ``serving_compiled_step``) is ROADMAP queue 5, a
  ``perf_opt`` PR after the port's benchmark.

JAX-only, both copies left out (they run in ``tests/test_serving.py``
itself): ``TestElasticChaosServing`` and
``test_kv_shm_claim_lands_in_pool_2proc`` start JAX child processes
(``jax.config.update("jax_platforms", "cpu")`` in their scripts);
``tests/test_torch_serving.py::test_kv_shm_claim_lands_in_pool_2proc``
is the port's own two-process claim.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)
from tests.torch_serving_swaps import SWAPS

torch_mirror.mirror(
    "tests/test_serving.py", globals(), swaps=SWAPS, cpu_mesh=True,
    names=["TestKvMigration", "TestContinuousBatchScheduler",
           "TestServingServices", "TestAutoscaler"])

# a numpy sender over the port's tensor payload, and queue 5 (above)
for _cls, _case in (
        (TestKvMigrationPort,  # noqa: F821
         "test_migrate_out_cutover_then_release"),
        (TestKvMigrationPort,  # noqa: F821
         "test_transfer_deadline_latches_and_revives"),
        (TestKvMigrationPort,  # noqa: F821
         "test_scheduler_fence_refuses_decoding_session"),
        (TestKvMigrationPort,  # noqa: F821
         "test_spilled_session_migrates_via_restore"),
        (TestContinuousBatchSchedulerPort,  # noqa: F821
         "test_compiled_step_parity")):
    setattr(_cls, _case, None)
