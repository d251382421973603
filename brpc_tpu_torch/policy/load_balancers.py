"""Load balancers: the locality-aware balancer (LALB) the serving router
picks decode workers with.

Reference: src/brpc/policy/locality_aware_load_balancer.{h,cpp} and
docs/cn/lalb.md, ported from :mod:`brpc_tpu.policy.load_balancers` (its
``LocalityAwareLB`` and the ``_ListLB`` membership base, with its
timed exclusions).  Every balancer joins a weak registry,
:func:`live_load_balancers`, through which the lame-duck registry pulls a
draining endpoint from all of them at once.  The other strategies there
have no caller in the port yet.
"""
from __future__ import annotations

import collections
import random
import threading
import time
import weakref
from typing import Dict, List, Optional

from ..butil.endpoint import EndPoint


class ServerEntry:
    __slots__ = ("endpoint", "weight", "tag")

    def __init__(self, endpoint: EndPoint, weight: int = 100, tag: str = ""):
        self.endpoint = endpoint
        self.weight = weight
        self.tag = tag


# Every live LB, weakly held: the lame-duck registry pulls a draining
# endpoint (GOODBYE) from ALL balancers at once (rpc/lameduck.py).
_live_lbs: "weakref.WeakSet" = weakref.WeakSet()


def live_load_balancers() -> List["_ListLB"]:
    return list(_live_lbs)


class _ListLB:
    """Membership: a list of ServerEntry replaced whole on every change, so
    a selection reads one immutable snapshot (the reference keeps it in
    DoublyBufferedData for the same reason), and timed exclusions: an
    endpoint excluded until ``until_ts`` (``time.monotonic()``) is not
    selected before then, unless every member is excluded."""

    def __init__(self):
        self._list_lock = threading.Lock()
        self._list: List[ServerEntry] = []
        self._excl_lock = threading.Lock()
        self._excluded: Dict[EndPoint, float] = {}
        _live_lbs.add(self)

    def add_server(self, ep: EndPoint, weight: int = 100,
                   tag: str = "") -> bool:
        with self._list_lock:
            if any(e.endpoint == ep for e in self._list):
                return False
            self._list = self._list + [ServerEntry(ep, weight, tag)]
            return True

    def remove_server(self, ep: EndPoint) -> bool:
        with self._list_lock:
            kept = [e for e in self._list if e.endpoint != ep]
            if len(kept) == len(self._list):
                return False
            self._list = kept
            return True

    def servers(self) -> List[ServerEntry]:
        return list(self._list)

    def exclude(self, ep: EndPoint, until_ts: float) -> None:
        """Keep ``ep`` out of selection until ``until_ts``: ``inf`` for a
        draining peer, 0 lifts the exclusion."""
        with self._excl_lock:
            if until_ts > 0:
                self._excluded[ep] = until_ts
            else:
                self._excluded.pop(ep, None)

    def _usable(self) -> List[ServerEntry]:
        lst = self._list
        if not self._excluded:       # the common case: no lock taken
            return lst
        now = time.monotonic()
        with self._excl_lock:
            excl = {ep for ep, ts in self._excluded.items() if ts > now}
        if not excl:
            return lst
        out = [e for e in lst if e.endpoint not in excl]
        # cluster-recover guard: if everything is excluded, serve anyway
        return out if out else lst


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

    def remove_server(self, ep: EndPoint) -> bool:
        """Drop ``ep`` and its latency window: a member added back later
        (an autoscaler's restarted worker) starts from INITIAL_WEIGHT
        instead of the window of the server that was stopped.  (The
        reference keeps the window across a removal.)"""
        ok = super().remove_server(ep)
        with self._w_lock:
            self._servers.pop(ep, None)
        return ok

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
        usable = self._usable()
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
