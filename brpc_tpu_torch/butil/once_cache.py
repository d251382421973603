"""Once-guarded build cache: build OUTSIDE the lock, publish under it.

Port of :mod:`brpc_tpu.butil.once_cache`, the shape a compile cache
needs: a build (a compiled program, a captured graph) can take seconds,
so holding the cache lock across ``builder()`` starves every OTHER key's
lookup; per-key once-guard
events make concurrent same-key callers wait on the build instead of
compiling twice, while different keys proceed immediately.  A failed
build clears its guard so waiters retry (and surface the same error)
rather than hang.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Optional, Tuple


def build_once(lock, cache: dict, building: Dict[Tuple, threading.Event],
               key, builder: Callable[[], Any],
               cap: Optional[int] = None):
    """Fetch ``cache[key]`` or build it exactly once.  ``lock`` guards
    both dicts; ``builder`` runs OUTSIDE it.  With ``cap`` (and an
    OrderedDict cache) entries are LRU-evicted on insert and touched on
    hit."""
    lru = isinstance(cache, collections.OrderedDict)
    while True:
        with lock:
            fn = cache.get(key)
            if fn is not None:
                if lru:
                    cache.move_to_end(key)
                return fn
            ev = building.get(key)
            if ev is None:
                ev = building[key] = threading.Event()
                break
        # another thread is building THIS key: wait off-lock (other
        # keys' lookups proceed — the point of the once-guard)
        ev.wait(120.0)
    try:
        fn = builder()
    except BaseException:
        with lock:
            building.pop(key, None)
        ev.set()
        raise
    with lock:
        cache[key] = fn
        if lru:
            cache.move_to_end(key)
            if cap:
                while len(cache) > cap:
                    cache.popitem(last=False)
        building.pop(key, None)
    ev.set()
    return fn
