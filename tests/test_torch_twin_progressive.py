"""``tests/test_progressive.py`` on both packages (``tests/torch_mirror.py``):
progressive attachments and the progressive reader.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_progressive.py", globals())
