"""``tests/test_collective_fanout.py``'s in-process classes and
module-level tests on both packages (``tests/torch_mirror.py``): the
compiled fan-out's screen, its parity with the per-member RPC loop, the
member kill mid-fan-out and its revival, the transient-failure re-probe
and budget, and the screen cache.  The port's copy runs on a CPU default
mesh of 8 ranks (``cpu_mesh=True``); its module-level tests take the
copy's own ``fan4`` fixture (``torch_mirror``).  The swaps are listed in
``tests/torch_array_swaps.py`` (``COLLECTIVE_FANOUT``: ``np.asarray`` of
a fan-out result).

Left out of the port's copy:
- ``TestXprocProgram::test_xproc_program_matches_local_leg``: it builds
  the JAX multi-controller program with ``_prepare_xproc`` (zeros rows
  and a psum broadcast under ``shard_map``).  The port's cross-process
  leg pulls each member's row over the fabric and runs no SPMD program;
  ``tests/test_torch_collective_fanout_xproc.py::
  test_xproc_execution_equals_local_leg_and_jax`` holds its result
  against the local leg and the JAX package's.
- ``TestCompileCacheOnceGuard`` (3 cases): the once-guard of
  ``Collectives._cached``, the JAX jit cache (ROADMAP queue 5).  The
  port's collectives run eagerly and compile nothing;
  ``tests/test_torch_collective_fanout.py::test_concurrent_fanouts_serialize``
  holds concurrent fan-outs on the port.

JAX-only, both copies left out (it runs in
``tests/test_collective_fanout.py`` itself):
``test_xproc_fanout_declines_and_forced_announce_degrades`` starts two
JAX child processes (``jax.config.update("jax_platforms", "cpu")`` in
their script); ``tests/test_torch_collective_fanout_xproc.py::
test_two_process_decline_and_refusal_equal_jax`` and
``test_forced_on_in_both_runs_the_leg`` are the port's two-process
decline and forced announce.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_collective_fanout.py", globals(),
                    swaps=torch_array_swaps.COLLECTIVE_FANOUT, cpu_mesh=True)

# the JAX SPMD program and jit cache (above)
del TestXprocProgramPort, TestCompileCacheOnceGuardPort  # noqa: F821
# JAX child processes (above)
del test_xproc_fanout_declines_and_forced_announce_degrades_jax  # noqa: F821
del test_xproc_fanout_declines_and_forced_announce_degrades_port  # noqa: F821
