"""The bthread layer on both packages: every test of
``tests/test_bthread.py`` over ``brpc_tpu`` and over ``brpc_tpu_torch``
(``tests/torch_mirror.py``).

Swaps in the port's copy (``TestDeviceWaiter``):
- ``test_wait_on_computation`` computes ``(x @ x).sum()`` eagerly on a CPU
  ``torch`` tensor where the JAX file jits it (the ``import jax`` and
  ``@jax.jit`` lines go);
- every ``import jax.numpy as jnp`` becomes ``import torch as jnp``
  (``ones``, ``full``, ``arange`` keep their spelling), so
  ``device_wait``/``device_on_ready`` wait on CPU tensors, which are
  complete when made: the callbacks run at once, in order.

No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror

torch_mirror.mirror("tests/test_bthread.py", globals(), swaps=[
    ("        import jax\n        import jax.numpy as jnp\n\n"
     "        @jax.jit\n", "        import jax.numpy as jnp\n\n"),
    ("import jax.numpy as jnp", "import torch as jnp"),
])
