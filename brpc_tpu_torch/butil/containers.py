"""Container utilities (reference: src/butil/containers/), the port's copy
of :mod:`brpc_tpu.butil.containers`.

FlatMap's open-addressing trick buys nothing over Python's dict, so FlatMap
is a dict subclass that keeps the reference's ``seek/insert/erase`` spelling;
the behavioral pieces — BoundedQueue (fixed-cap ring used by work queues),
CaseIgnoredFlatMap (HTTP headers) and MRUCache — are real implementations.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Generic, Iterator, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class FlatMap(dict):
    """dict with the reference's member spelling (flat_map.h)."""

    def seek(self, key):
        return self.get(key)

    def insert(self, key, value) -> None:
        self[key] = value

    def erase(self, key) -> int:
        return 1 if self.pop(key, _MISSING) is not _MISSING else 0


_MISSING = object()


class CaseIgnoredFlatMap(Generic[V]):
    """Case-insensitive string map preserving original key case
    (reference: case_ignored_flat_map.h; used for HTTP headers)."""

    def __init__(self):
        self._d: Dict[str, Tuple[str, V]] = {}

    def __setitem__(self, key: str, value: V) -> None:
        self._d[key.lower()] = (key, value)

    def __getitem__(self, key: str) -> V:
        return self._d[key.lower()][1]

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._d

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: str, default: Optional[V] = None) -> Optional[V]:
        e = self._d.get(key.lower())
        return e[1] if e is not None else default

    def items(self) -> Iterator[Tuple[str, V]]:
        return iter(self._d.values())

    def keys(self):
        return (orig for orig, _ in self._d.values())


class BoundedQueue(Generic[V]):
    """Fixed-capacity FIFO ring (reference: bounded_queue.h).  Non-blocking
    push/pop returning success, as used by TaskGroup run queues."""

    __slots__ = ("_buf", "_cap", "_head", "_count", "_lock")

    def __init__(self, capacity: int):
        self._buf: list = [None] * capacity
        self._cap = capacity
        self._head = 0
        self._count = 0
        self._lock = threading.Lock()

    def push(self, item: V) -> bool:
        with self._lock:
            if self._count == self._cap:
                return False
            self._buf[(self._head + self._count) % self._cap] = item
            self._count += 1
            return True

    def pop(self) -> Tuple[bool, Optional[V]]:
        with self._lock:
            if self._count == 0:
                return False, None
            item = self._buf[self._head]
            self._buf[self._head] = None
            self._head = (self._head + 1) % self._cap
            self._count -= 1
            return True, item

    def full(self) -> bool:
        return self._count == self._cap

    def empty(self) -> bool:
        return self._count == 0

    def __len__(self) -> int:
        return self._count

    def capacity(self) -> int:
        return self._cap


class MRUCache(Generic[K, V]):
    """Most-recently-used bounded cache (reference: mru_cache.h)."""

    def __init__(self, max_size: int):
        self._max = max_size
        self._d: "collections.OrderedDict[K, V]" = collections.OrderedDict()

    def put(self, key: K, value: V) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self._max:
            self._d.popitem(last=False)

    def get(self, key: K) -> Optional[V]:
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def __len__(self) -> int:
        return len(self._d)
