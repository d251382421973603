"""``tests/test_http.py`` on both packages (``tests/torch_mirror.py``):
JSON RPC and the builtin admin pages over one port.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_http.py", globals())
