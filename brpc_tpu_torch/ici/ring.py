"""Ring pipelines: chained Send/Recv with credit flow control.

The reference's closest thing to sequence parallelism is Streaming RPC's
sliding window (stream.cpp:274,307) and RDMA's explicit-ACK window
(rdma_endpoint.cpp): ordered chunk pipelines with credits.  Here that
machinery becomes what ring/context-parallel patterns are made of:

  * ``ring_all_reduce`` — the ring accumulate as n−1 hops of
    ``Collectives.ppermute`` plus adds, in the order of the JAX package's
    ``lax.scan`` of ``ppermute`` (and of the ring kernel): its rows equal
    :func:`.pallas_ring.ring_all_reduce`'s bit for bit.
  * ``RingStream`` — host-paced chunk pipeline: a device payload moves
    hop-by-hop as chunks with a sliding credit window; receiver
    consumption returns credits (the StreamingRPC feedback loop), device
    completion observed through the device waiter.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from ..bthread.device_waiter import DeviceEventDispatcher
from .collective import Collectives
from .mesh import IciMesh, ShardedTensor


def ring_all_reduce(x: ShardedTensor,
                    mesh: Optional[IciMesh] = None) -> ShardedTensor:
    """All-reduce (sum) of a (n, chunk...) sharded value via explicit ring
    hops: the carry starts as each rank's chunk, moves one hop per step
    and gains the local chunk at every stop.  After n−1 hops rank d holds
    ``x[d+1] + ... + x[d]`` (mod n).  ``mesh`` defaults to x's."""
    mesh = mesh or x.mesh
    n = mesh.size
    if n == 1:
        return x
    coll = Collectives(mesh)
    acc = x
    for _ in range(n - 1):
        moved = coll.ppermute(acc, 1)
        acc = ShardedTensor.adopt(
            [a + c for a, c in zip(moved.rows, x.rows)], mesh)
    return acc


class RingStream:
    """Sliding-window chunk pipeline between ring neighbors.

    Sender pushes chunks (sharded values); each chunk advances one hop per
    write via ppermute; the receiver's ``on_chunk`` consumes it and returns
    a credit.  ``window`` bounds in-flight chunks exactly like the
    reference stream's ``_produced - _remote_consumed < window`` check
    (stream.cpp:274); device completion is the delivery signal.
    """

    def __init__(self, hops: int = 1, window: int = 4,
                 mesh: Optional[IciMesh] = None,
                 on_chunk: Optional[Callable] = None):
        self.mesh = mesh or IciMesh.default()
        self.coll = Collectives(self.mesh)
        self.hops = hops
        self.window = window
        self.on_chunk = on_chunk
        # window accounting: produced - consumed < window, one condition
        # guards both (the stream.cpp:274 check, host-side pacing only)
        self._cv = threading.Condition()
        self._produced = 0
        self._consumed = 0

    def write(self, chunk, timeout: float = 30.0) -> bool:
        """Send one chunk ((n, ...) sharded row layout); blocks while the
        window is exhausted (AppendIfNotFull semantics)."""
        import time
        from ..bthread import scheduler
        deadline = time.monotonic() + timeout
        # check-and-RESERVE under one lock (the stream.cpp:274
        # AppendIfNotFull discipline): two concurrent writers must not
        # both pass the check before either counts itself, or the window
        # overshoots and a racing flush() reports drained while a chunk
        # is mid-dispatch
        with self._cv:
            while self._produced - self._consumed >= self.window:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                scheduler.note_worker_blocked()
                try:
                    self._cv.wait(left)
                finally:
                    scheduler.note_worker_unblocked()
            self._produced += 1          # reservation
        try:
            moved = chunk
            for _ in range(self.hops):
                moved = self.coll.ppermute(moved, 1)
            DeviceEventDispatcher.instance().on_ready(
                moved, lambda m=moved: self._delivered(m))
        except BaseException:
            # failed dispatch returns its reserved credit and wakes both
            # blocked writers and flush()ers
            with self._cv:
                self._produced -= 1
                self._cv.notify_all()
            raise
        return True

    def _delivered(self, chunk) -> None:
        try:
            if self.on_chunk is not None:
                self.on_chunk(chunk)
        finally:
            # feedback: credit returns to the sender (SendFeedback
            # analogue) and flush()ers see consumption progress
            with self._cv:
                self._consumed += 1
                self._cv.notify_all()

    def flush(self, timeout: float = 60.0) -> bool:
        """Wait until every produced chunk was consumed (no busy-poll:
        rides the same condition as the window credits)."""
        from ..bthread import scheduler
        with self._cv:
            scheduler.note_worker_blocked()
            try:
                return self._cv.wait_for(
                    lambda: self._consumed >= self._produced, timeout)
            finally:
                scheduler.note_worker_unblocked()

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._produced - self._consumed
