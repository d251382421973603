"""Per-thread fast random numbers (reference: src/butil/fast_rand.cpp).

Port of the generator half of :mod:`brpc_tpu.butil.misc`: the same
xorshift64* step, so a state seeded alike draws the same sequence in both
packages.  The draws come from a :class:`FastRand`: by default one per
thread, seeded from the thread id and the clock as in the reference; a
caller that needs a reproducible sequence passes its own seeded
``FastRand`` (the balancers take one as ``rng``) or seeds the calling
thread's with :func:`seed_fast_rand`.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

_MASK = 0xFFFFFFFFFFFFFFFF
_tls = threading.local()


class FastRand:
    """xorshift64* over one 64-bit state (fast_rand.cpp)."""

    __slots__ = ("state",)

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            seed = (threading.get_ident() * 2654435761
                    + time.monotonic_ns()) & _MASK
        self.state = (seed & _MASK) or 0x9E3779B97F4A7C15

    def next(self) -> int:
        x = self.state
        x ^= (x >> 12) & _MASK
        x = (x ^ (x << 25)) & _MASK
        x ^= x >> 27
        self.state = x
        return (x * 0x2545F4914F6CDD1D) & _MASK

    def less_than(self, n: int) -> int:
        return self.next() % n if n > 0 else 0


def _thread_rand() -> FastRand:
    r = getattr(_tls, "rand", None)
    if r is None:
        r = _tls.rand = FastRand()
    return r


def seed_fast_rand(seed: int) -> None:
    """Seed the calling thread's generator (tests, reproducible runs)."""
    _tls.rand = FastRand(seed)


def fast_rand(rng: Optional[FastRand] = None) -> int:
    """One 64-bit draw (span and trace ids)."""
    return (rng or _thread_rand()).next()


def fast_rand_less_than(n: int, rng: Optional[FastRand] = None) -> int:
    return (rng or _thread_rand()).less_than(n)
