"""``tests/test_integration.py`` on both packages (``tests/torch_mirror.py``):
channel, naming, balancer, circuit breaker and health-check
revival across a server's death.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_integration.py", globals())
