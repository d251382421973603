"""Load balancers: the locality-aware balancer (LALB) the serving router
picks decode workers with.

Reference: src/brpc/policy/locality_aware_load_balancer.{h,cpp} and
docs/cn/lalb.md, ported from :mod:`brpc_tpu.policy.load_balancers` (its
``LocalityAwareLB`` and the ``_ListLB`` membership base).  The other
strategies there have no caller in the port yet.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Dict, List, Optional

from ..butil.endpoint import EndPoint


class ServerEntry:
    __slots__ = ("endpoint", "weight", "tag")

    def __init__(self, endpoint: EndPoint, weight: int = 100, tag: str = ""):
        self.endpoint = endpoint
        self.weight = weight
        self.tag = tag


class _ListLB:
    """Membership: a list of ServerEntry replaced whole on every change, so
    a selection reads one immutable snapshot (the reference keeps it in
    DoublyBufferedData for the same reason)."""

    def __init__(self):
        self._list_lock = threading.Lock()
        self._list: List[ServerEntry] = []

    def add_server(self, ep: EndPoint, weight: int = 100,
                   tag: str = "") -> bool:
        with self._list_lock:
            if any(e.endpoint == ep for e in self._list):
                return False
            self._list = self._list + [ServerEntry(ep, weight, tag)]
            return True

    def servers(self) -> List[ServerEntry]:
        return list(self._list)


class _LaWeight:
    """One server's LALB state (reference Weight): a window of latency
    samples and the sum of the begin times of its in-flight requests.

    * ``base weight`` = WEIGHT_SCALE / avg_latency over the window —
      proportional to the server's observed QPS capacity;
    * **error punishment**: a failed call contributes ``avg × PUNISH_RATIO``
      instead of its real latency, so a failing server's weight collapses
      and successful calls wash the punishment out again;
    * **in-flight extrapolation** (the "divided weight"): a server whose
      in-flight requests have already waited longer than its average is
      predicted slower than its window says, and its weight is divided by
      elapsed/avg at selection time."""

    __slots__ = ("samples", "latency_sum", "begin_time_sum",
                 "begin_time_count")

    QUEUE_SIZE = 128            # reference RECV_QUEUE_SIZE
    PUNISH_RATIO = 4.0          # error sample = avg * ratio

    def __init__(self):
        self.samples = collections.deque(maxlen=self.QUEUE_SIZE)
        self.latency_sum = 0.0
        self.begin_time_sum = 0.0    # sum of in-flight begin times (us)
        self.begin_time_count = 0

    def avg_latency(self) -> float:
        return (self.latency_sum / len(self.samples)
                if self.samples else 0.0)

    def push(self, latency_us: float) -> None:
        if len(self.samples) == self.samples.maxlen:
            self.latency_sum -= self.samples[0]
        self.samples.append(latency_us)
        self.latency_sum += latency_us


class LocalityAwareLB(_ListLB):
    """LALB: weight ∝ WEIGHT_SCALE / avg latency, errors punished as
    inflated samples, in-flight extrapolation dividing a stuck server's
    weight.  Selection is weighted-random over the effective weights (the
    reference's weight tree indexes the same distribution) and MIN_WEIGHT
    keeps every server reachable, so a punished one still gets the probe
    traffic it needs to recover.  ``rng`` draws the selections; pass a
    seeded ``random.Random`` for a reproducible sequence."""

    WEIGHT_SCALE = 1e7
    INITIAL_WEIGHT = 1000.0     # until the first sample lands
    MIN_WEIGHT = 1.0

    def __init__(self, rng: Optional[random.Random] = None):
        super().__init__()
        self._rng = rng or random.Random()
        self._w_lock = threading.Lock()
        self._servers: Dict[EndPoint, _LaWeight] = {}

    def _weight_for(self, ep: EndPoint) -> _LaWeight:
        w = self._servers.get(ep)
        if w is None:
            w = self._servers[ep] = _LaWeight()
        return w

    def _effective_weight(self, w: _LaWeight, now_us: float) -> float:
        avg = w.avg_latency()
        if avg <= 0:
            return self.INITIAL_WEIGHT
        base = self.WEIGHT_SCALE / avg
        if w.begin_time_count > 0:
            avg_begin = w.begin_time_sum / w.begin_time_count
            elapsed = now_us - avg_begin
            if elapsed > avg:
                base = base * avg / elapsed         # the divided weight
        return max(base, self.MIN_WEIGHT)

    def select_server(self) -> Optional[EndPoint]:
        usable = self._list
        if not usable:
            return None
        now_us = time.monotonic() * 1e6
        with self._w_lock:
            ws = [self._effective_weight(self._weight_for(e.endpoint),
                                         now_us) for e in usable]
            r = self._rng.random() * sum(ws)
            acc = 0.0
            chosen = usable[-1].endpoint
            for e, w in zip(usable, ws):
                acc += w
                if r < acc:
                    chosen = e.endpoint
                    break
            # note the in-flight begin (reference Weight::AddInflight):
            # feedback() subtracts it back out
            cw = self._weight_for(chosen)
            cw.begin_time_sum += now_us
            cw.begin_time_count += 1
            return chosen

    def feedback(self, ep: EndPoint, error_code: int,
                 latency_us: int) -> None:
        now_us = time.monotonic() * 1e6
        with self._w_lock:
            w = self._weight_for(ep)
            # retire one in-flight entry: its begin time is ≈ now - latency
            if w.begin_time_count > 0:
                w.begin_time_sum -= now_us - latency_us
                w.begin_time_count -= 1
                if w.begin_time_count == 0:
                    w.begin_time_sum = 0.0
            if error_code != 0:
                punished = max(w.avg_latency(), float(latency_us), 1.0) \
                    * _LaWeight.PUNISH_RATIO
                w.push(punished)
            else:
                w.push(max(float(latency_us), 1.0))

    def cancel_inflight(self, ep: EndPoint) -> None:
        """Retire one in-flight entry without a latency sample: a selection
        discarded before any request was issued.  Without this, discarded
        draws would pin the server near MIN_WEIGHT through phantom
        in-flight entries."""
        now_us = time.monotonic() * 1e6
        with self._w_lock:
            w = self._weight_for(ep)
            if w.begin_time_count > 0:
                w.begin_time_sum -= now_us
                w.begin_time_count -= 1
                if w.begin_time_count == 0:
                    w.begin_time_sum = 0.0

    def weight_of(self, ep: EndPoint) -> float:
        with self._w_lock:
            return self._effective_weight(self._weight_for(ep),
                                          time.monotonic() * 1e6)
