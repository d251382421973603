"""``tests/test_server_lifecycle.py`` on both packages
(``tests/torch_mirror.py``): the lame-duck drain, GOODBYE and the health
checker's revival, mesh:// naming of a draining member, the drain
barrier over posted device-plane transfers
(``TestDevicePlaneDrainBarrier``), lifecycle hygiene, the graceful quit
on SIGTERM and the drain under batched delivery.  The port's copy runs on
a CPU default mesh of 8 ranks (``cpu_mesh=True``); the swaps are listed
in ``tests/torch_array_swaps.py`` (``SERVER_LIFECYCLE``).

No case is left out: ``TestGracefulQuitOnSigterm`` starts a child
process, and the port's copy starts it on the port (its script imports
``brpc_tpu_torch``, no JAX), so it runs on both packages.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_server_lifecycle.py", globals(),
                    swaps=torch_array_swaps.SERVER_LIFECYCLE, cpu_mesh=True)
