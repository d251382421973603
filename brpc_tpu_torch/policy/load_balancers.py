"""Load balancers (reference: src/brpc/policy/*_load_balancer.cpp,
registered in global.cpp:141-150; interface load_balancer.h).

Ported from :mod:`brpc_tpu.policy.load_balancers`: round robin, weighted
round robin, randomized, weighted randomized, consistent hashing (murmur3,
md5, ketama), locality-aware (LALB, which the serving router picks decode
workers with) and dynpart, built by name with
:func:`create_load_balancer`.  They share the ``_ListLB`` membership base
with its timed exclusions.  The random strategies draw from
:mod:`..butil.misc`'s xorshift generator: over one server list and one
seed they pick the same sequence as the JAX package's.  Every balancer
joins a weak registry, :func:`live_load_balancers`, through which the
lame-duck registry pulls a draining endpoint from all of them at once.
"""
from __future__ import annotations

import bisect
import collections
import hashlib
import random
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from ..butil.endpoint import EndPoint
from ..butil.misc import FastRand, fast_rand_less_than


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

    def reset_servers(self, entries: List[ServerEntry]) -> None:
        """Replace the membership (the naming watcher's interface)."""
        with self._list_lock:
            self._list = [ServerEntry(e.endpoint, e.weight, e.tag)
                          for e in entries]

    def server_count(self) -> int:
        return len(self._list)

    def servers(self) -> List[ServerEntry]:
        return list(self._list)

    def feedback(self, ep: EndPoint, error_code: int,
                 latency_us: int) -> None:
        pass

    def exclude(self, ep: EndPoint, until_ts: float) -> None:
        """Keep ``ep`` out of selection until ``until_ts``: ``inf`` for a
        draining peer, 0 lifts the exclusion."""
        with self._excl_lock:
            if until_ts > 0:
                self._excluded[ep] = until_ts
            else:
                self._excluded.pop(ep, None)

    def _usable(self, cntl=None) -> List[ServerEntry]:
        lst = self._list
        per_call = getattr(cntl, "_excluded_servers", None) \
            if cntl is not None else None
        if not self._excluded and not per_call:   # no lock taken
            return lst
        now = time.monotonic()
        with self._excl_lock:
            excl = {ep for ep, ts in self._excluded.items() if ts > now}
        if per_call:
            excl |= set(per_call)
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

    name = "la"
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

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        usable = self._usable(cntl)
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


class RoundRobinLB(_ListLB):
    name = "rr"

    def __init__(self):
        super().__init__()
        self._index = 0
        self._ilock = threading.Lock()

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        usable = self._usable(cntl)
        if not usable:
            return None
        with self._ilock:
            self._index = (self._index + 1) % len(usable)
            return usable[self._index].endpoint


class WeightedRoundRobinLB(_ListLB):
    """Smooth weighted round robin (the distribution contract of
    weighted_round_robin_load_balancer.cpp)."""

    name = "wrr"

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._current: Dict[EndPoint, int] = {}

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        usable = self._usable(cntl)
        if not usable:
            return None
        with self._lock:
            total = 0
            best = None
            for e in usable:
                cur = self._current.get(e.endpoint, 0) + e.weight
                self._current[e.endpoint] = cur
                total += e.weight
                if best is None or cur > self._current[best.endpoint]:
                    best = e
            self._current[best.endpoint] -= total
            return best.endpoint


class RandomizedLB(_ListLB):
    """Uniform over the usable members.  ``rng`` draws the picks (the
    calling thread's generator when None)."""

    name = "random"

    def __init__(self, rng: Optional[FastRand] = None):
        super().__init__()
        self._rng = rng

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        usable = self._usable(cntl)
        if not usable:
            return None
        return usable[fast_rand_less_than(len(usable), self._rng)].endpoint


def _weighted_pick(usable: List[ServerEntry],
                   rng: Optional[FastRand]) -> EndPoint:
    total = sum(e.weight for e in usable)
    r = fast_rand_less_than(max(total, 1), rng)
    acc = 0
    for e in usable:
        acc += e.weight
        if r < acc:
            return e.endpoint
    return usable[-1].endpoint


class WeightedRandomizedLB(RandomizedLB):
    name = "wr"

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        usable = self._usable(cntl)
        if not usable:
            return None
        return _weighted_pick(usable, self._rng)


def _murmur32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 (the reference's murmurhash3 third_party lib)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed
    rounded = len(data) & ~3
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _md5_32(data: bytes) -> int:
    return int.from_bytes(hashlib.md5(data).digest()[:4], "little")


class ConsistentHashingLB(_ListLB):
    """Ketama-style ring with virtual nodes
    (consistent_hashing_load_balancer.cpp + hasher.cpp).  ``kind`` selects
    the hash: murmur | md5 | ketama (md5-based, four points per digest).
    A call's ``cntl.request_code`` is its key; without one the key is a
    random draw."""

    def __init__(self, kind: str = "murmur", vnodes: int = 64):
        super().__init__()
        self.kind = kind
        self.name = "c_" + kind + "hash"
        self._vnodes = vnodes
        self._ring_lock = threading.Lock()
        self._ring: List[Tuple[int, EndPoint]] = []

    def _hash(self, data: bytes) -> int:
        if self.kind == "murmur":
            return _murmur32(data)
        return _md5_32(data)

    def _rebuild(self) -> None:
        ring = []
        for e in self._list:
            base = str(e.endpoint).encode()
            if self.kind == "ketama":
                for i in range((self._vnodes + 3) // 4):
                    d = hashlib.md5(base + b"-%d" % i).digest()
                    for j in range(4):
                        ring.append((int.from_bytes(d[j * 4:j * 4 + 4],
                                                    "little"), e.endpoint))
            else:
                for i in range(self._vnodes):
                    ring.append((self._hash(base + b"-%d" % i), e.endpoint))
        ring.sort()
        with self._ring_lock:
            self._ring = ring

    def add_server(self, ep, weight=100, tag="") -> bool:
        ok = super().add_server(ep, weight, tag)
        if ok:
            self._rebuild()
        return ok

    def remove_server(self, ep) -> bool:
        ok = super().remove_server(ep)
        if ok:
            self._rebuild()
        return ok

    def reset_servers(self, entries) -> None:
        super().reset_servers(entries)
        self._rebuild()

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        code = getattr(cntl, "request_code", None) \
            if cntl is not None else None
        if code is None:
            code = fast_rand_less_than(1 << 32)
        h = self._hash(code if isinstance(code, bytes)
                       else str(code).encode())
        with self._ring_lock:
            ring = self._ring
        if not ring:
            return None
        i = bisect.bisect_left(ring, (h,))
        return ring[i % len(ring)][1]


class DynPartLB(RandomizedLB):
    """dynpart (dynpart_load_balancer.cpp): selection proportional to each
    member's weight, the capacity a DynamicPartitionChannel scheme
    announces."""

    name = "dynpart"

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        usable = self._usable(cntl)
        if not usable:
            return None
        return _weighted_pick(usable, self._rng)


_factories = {
    "rr": RoundRobinLB,
    "wrr": WeightedRoundRobinLB,
    "random": RandomizedLB,
    "wr": WeightedRandomizedLB,
    "c_murmurhash": lambda: ConsistentHashingLB("murmur"),
    "c_md5": lambda: ConsistentHashingLB("md5"),
    "c_ketama": lambda: ConsistentHashingLB("ketama"),
    "la": LocalityAwareLB,
    "dynpart": DynPartLB,
}


def create_load_balancer(name: str) -> _ListLB:
    try:
        return _factories[name]()
    except KeyError:
        raise ValueError(f"unknown load balancer {name!r}; "
                         f"have {sorted(_factories)}")


def list_load_balancers() -> List[str]:
    return sorted(_factories)
