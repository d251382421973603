"""``tests/test_grpc.py`` on both packages (``tests/torch_mirror.py``):
HTTP/2 and gRPC: frame and HPACK golden checks and in-process
client-to-server calls.

No swap and no case left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_grpc.py", globals())
