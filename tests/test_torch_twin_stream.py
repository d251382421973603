"""``tests/test_stream.py`` on both packages (``tests/torch_mirror.py``):
streams over mem://, the flow-control window, the stream over ``ici://``
and the bulk-plane routing of large DATA frames.

The port's copy runs on a CPU default mesh of 8 ranks (``cpu_mesh=True``),
where the JAX copy's ``ici://`` stream relies on JAX's 8 CPU devices.

Swaps in the port's copy, in ``TestStreamBulkRouting``'s fake socket:
the port's stream reserves a large frame through the fabric's
``stream_fast_begin(nbytes, affinity=sid)`` (which names the route) and
sends and aborts it with ``stream_fast_send(route, uuid, frame)`` and
``stream_fast_abort(route)``; the legacy single-plane names
``stream_bulk_begin``/``stream_bulk_send``, which the JAX stream still
reaches through ``getattr``, are on the census's allowlist
(``tests/test_torch_surface.py``).  The fake takes the port's names and
the same threshold routing, order, close-on-send-failure without
deadlock and socket failure on a failed claim must hold.

No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_stream.py", globals(), swaps=[
    ("    def stream_bulk_begin(self):\n"
     "        self._next_uuid += 1\n"
     "        return self._next_uuid\n\n"
     "    def stream_bulk_send(self, uuid, frame):\n",
     "    def stream_fast_begin(self, nbytes, affinity=0):\n"
     "        self._next_uuid += 1\n"
     "        return self._next_uuid, \"bulk\"\n\n"
     "    def stream_fast_abort(self, route):\n"
     "        self.aborted = route\n\n"
     "    def stream_fast_send(self, route, uuid, frame):\n"),
    ("        def broken_send(uuid, frame):\n",
     "        def broken_send(route, uuid, frame):\n"),
    ("        a.stream_bulk_send = broken_send\n",
     "        a.stream_fast_send = broken_send\n"),
], cpu_mesh=True)
