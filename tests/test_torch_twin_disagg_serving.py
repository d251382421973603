"""``tests/test_disagg_serving.py`` on both packages
(``tests/torch_mirror.py``): the disaggregated prefill/decode example on
the in-process mesh, the KV handoff crossing the device plane, the
tokens bit-exact against the single-process reference, and the decode
worker releasing every session.  The port's copy runs on a CPU default
mesh of 8 ranks (``cpu_mesh=True``); the swaps are listed in
``tests/torch_array_swaps.py`` (``DISAGG_SERVING``).

No case is left out.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_disagg_serving.py", globals(),
                    swaps=torch_array_swaps.DISAGG_SERVING, cpu_mesh=True)
