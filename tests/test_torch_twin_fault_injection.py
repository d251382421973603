"""``tests/test_fault_injection.py`` on both packages (``tests/torch_mirror.py``):
fault injection driving retries, backup requests and
failover.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_fault_injection.py", globals())
