"""ResourcePool: slab-style object pool addressed by versioned 64-bit ids.

Reference: src/butil/resource_pool.h:96-118.  The reference hands out ids
whose high bits embed a 32-bit *version*; ``Address(id)`` returns NULL unless
the stored version matches, which makes every handle revocable without
locking (ABA-safe).  This is the foundation of SocketId, bthread_t, and
correlation ids, and it ports to the host runtime unchanged: the pool is a
python-level slab of slots, each slot carrying (version, payload).

Id layout: ``id = (version << 32) | slot``.  Versions start at 1 and bump by
2 on every free, so a given id can never be revived — exactly the reference's
"id can be revoked but never forged" contract.
"""
from __future__ import annotations

from typing import Any, Generic, List, Optional, TypeVar

from . import debug_sync as _dbg

T = TypeVar("T")

INVALID_ID = 0


def id_slot(rid: int) -> int:
    return rid & 0xFFFFFFFF


def id_version(rid: int) -> int:
    return (rid >> 32) & 0xFFFFFFFF


def make_id(version: int, slot: int) -> int:
    return ((version & 0xFFFFFFFF) << 32) | (slot & 0xFFFFFFFF)


class ResourcePool(Generic[T]):
    """Versioned-id pool.  get() -> (id, set_payload), address(id) -> payload."""

    _GUARDED_BY = {"_slots": "_lock", "_free": "_lock"}

    def __init__(self):
        self._slots: List[List[Any]] = []   # each: [version, payload, in_use]
        self._free: List[int] = []
        self._lock = _dbg.make_lock("ResourcePool._lock")

    def get_resource(self, payload: T) -> int:
        with self._lock:
            if self._free:
                slot = self._free.pop()
                entry = self._slots[slot]
                entry[1] = payload
                entry[2] = True
                return make_id(entry[0], slot)
            slot = len(self._slots)
            self._slots.append([1, payload, True])
            return make_id(1, slot)

    def address(self, rid: int) -> Optional[T]:
        """Wait-free in the reference; here a plain bounds+version check
        (no lock: slot list only ever grows, version mismatch is benign)."""
        slot = id_slot(rid)
        if slot >= len(self._slots):  # fablint: ignore[guarded-state] wait-free by design: the slot list only grows, so a stale length is a benign miss
            return None
        entry = self._slots[slot]  # fablint: ignore[guarded-state] wait-free by design: the version check below rejects any entry recycled mid-read
        if entry[0] != id_version(rid) or not entry[2]:
            return None
        return entry[1]

    def return_resource(self, rid: int) -> bool:
        slot = id_slot(rid)
        with self._lock:
            if slot >= len(self._slots):
                return False
            entry = self._slots[slot]
            if entry[0] != id_version(rid) or not entry[2]:
                return False
            entry[0] = (entry[0] + 2) & 0xFFFFFFFF  # bump: old ids dead forever
            entry[1] = None
            entry[2] = False
            self._free.append(slot)
            return True

    def size(self) -> int:
        with self._lock:
            return len(self._slots) - len(self._free)

    def live_payloads(self) -> List[T]:
        """Snapshot of every in-use payload, taken under the pool lock —
        the supported enumeration (debug pages, drain gates) instead of
        callers walking ``_slots`` racily against slot recycling."""
        with self._lock:
            return [entry[1] for entry in self._slots if entry[2]]
