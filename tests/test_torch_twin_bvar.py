"""``tests/test_bvar.py`` on both packages (``tests/torch_mirror.py``):
reducers, windows, latency recorders, families, the collector and the
default variables.

Swaps in the port's copy: the default variable ``tpu_device_count``
(``brpc_tpu/bvar/default_variables.py``) is ``cuda_device_count`` in the
port (``brpc_tpu_torch/bvar/default_variables.py``), which counts the
CUDA devices; the test's ``tpu_*`` filter reads ``cuda_*``.

No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror

torch_mirror.mirror("tests/test_bvar.py", globals(), swaps=[
    ('assert "tpu_device_count" in dict(bvar.dump_exposed("tpu_*"))',
     'assert "cuda_device_count" in dict(bvar.dump_exposed("cuda_*"))'),
])
