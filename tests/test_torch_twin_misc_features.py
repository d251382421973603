"""``tests/test_misc_features.py`` on both packages (``tests/torch_mirror.py``):
ns_filter, EOVERCROWDED, RESTful mappings, pooled and short
connections.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_misc_features.py", globals())
