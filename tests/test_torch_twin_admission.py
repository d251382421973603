"""``tests/test_admission.py`` on both packages (``tests/torch_mirror.py``).

Swaps in the port's copy:
- ``IciMesh(jax.devices())``, the JAX CPU platform's 8 devices, is the
  port's 8-rank CPU mesh (``IciMesh(8, device="cpu")``).
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_admission.py", globals(), swaps=[
    ("IciMesh(jax.devices())", 'IciMesh(8, device="cpu")'),
], cpu_mesh=True)
