"""``tests/test_policy.py`` on both packages (``tests/torch_mirror.py``):
the load balancers, naming services, limiters and circuit breaker.

Swaps in the port's copy:
- ``test_mesh_ns_matches_device_mesh``: ``len(jax.devices())``, the JAX
  CPU platform's 8 devices, is the port's default mesh's size
  (``IciMesh.default().size``); the port's copy runs on a CPU default
  mesh of 8 ranks (``cpu_mesh=True``).

No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror

torch_mirror.mirror("tests/test_policy.py", globals(), swaps=[
    ("        import jax\n        assert len(entries) == len(jax.devices())",
     "        from brpc_tpu.ici import IciMesh\n"
     "        assert len(entries) == IciMesh.default().size"),
], cpu_mesh=True)
