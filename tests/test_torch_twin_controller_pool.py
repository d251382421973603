"""``tests/test_controller_pool.py`` on both packages
(``tests/torch_mirror.py``): the pooled server-side controllers' reset
contract, at the pool and through servers on mem:// and the native
``ici://`` plane.

The port's copy runs on a CPU default mesh of 8 ranks (``cpu_mesh=True``),
where the JAX copy's ``ici://7`` server relies on JAX's 8 CPU devices.
No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_controller_pool.py", globals(),
                    cpu_mesh=True)
