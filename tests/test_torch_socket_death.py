"""Connection death on both packages: every test of
``tests/test_socket_death.py`` over ``brpc_tpu`` and over ``brpc_tpu_torch``
(``tests/torch_mirror.py``, no swap).  A peer that reads a call and closes
fails the in-flight call at once with a retryable code, on tpu_std and on
the pipelined redis protocol, instead of after the whole deadline.
"""
from __future__ import annotations

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_socket_death.py", globals())
