"""``tests/test_channels.py`` on both packages (``tests/torch_mirror.py``).

The port's copy runs on a CPU default mesh of 8 ranks (``cpu_mesh=True``),
where the JAX copy relies on JAX's 8 CPU devices.  The port's ``ParallelChannel`` carries the JAX name
``_inline_eligible`` for its inline-issue screen.

Left out of the port's copy:
- ``TestCollectiveLowering`` (4 cases): its operands are spelled in JAX's
  array API (``jnp.ones(shape, jnp.float32)`` with a positional dtype,
  ``y.sharding.device_set``) and it reads the jit cache
  ``CollectiveChannel._compiled``; the port runs a handler per rank over a
  ``ShardedTensor`` and compiles nothing.  ``tests/test_torch_collectives.py``
  holds the port's ``CollectiveChannel`` against the JAX one on the same
  operands.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_channels.py", globals(), cpu_mesh=True)

# JAX's array API and jit cache (above)
del TestCollectiveLoweringPort  # noqa: F821
