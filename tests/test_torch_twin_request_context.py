"""``tests/test_request_context.py`` on both packages (``tests/torch_mirror.py``):
the cascading request context: a handler's outbound calls
inherit the inbound priority, tenant and the decremented deadline budget.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_request_context.py", globals())
