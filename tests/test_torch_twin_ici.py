"""``tests/test_ici.py`` on both packages (``tests/torch_mirror.py``):
the ``ici://`` echo, DEVICE payloads delivered resident on the server's
rank, the transport's byte counters (``ici.ici_transport_stats``), the
sliding window, ordered delivery, the collectives and the ring entry
points.  The port's copy runs on a CPU default mesh of 8 ranks
(``cpu_mesh=True``); the swaps are listed in
``tests/torch_array_swaps.py`` (``ICI``).

No case is left out.
"""
from __future__ import annotations

from tests import torch_array_swaps
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_ici.py", globals(),
                    swaps=torch_array_swaps.ICI, cpu_mesh=True)
