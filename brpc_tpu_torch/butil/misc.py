"""Misc platform utilities (reference: src/butil/ fast_rand, crc32c, time).

Port of :mod:`brpc_tpu.butil.misc`.  The generator is the same
xorshift64* step, so a state seeded alike draws the same sequence in both
packages.  The draws come from a :class:`FastRand`: by default one per
thread, seeded from the thread id and the clock as in the reference; a
caller that needs a reproducible sequence passes its own seeded
``FastRand`` (the balancers take one as ``rng``) or seeds the calling
thread's with :func:`seed_fast_rand`.

``crc32c`` is the Castagnoli CRC (reflected polynomial 0x82F63B78, the
iSCSI / RFC 3720 checksum), table-driven with 8 slice tables.  The time
helpers, ``Timer`` and the 24-bit big-endian helpers of the RTMP and FLV
headers (``u24``/``p24``) are as in the reference.
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


def fast_rand_in(lo: int, hi: int, rng: Optional[FastRand] = None) -> int:
    return lo + fast_rand_less_than(hi - lo + 1, rng)


def _crc32c_tables():
    """8 slicing tables for the reflected Castagnoli polynomial."""
    poly = 0x82F63B78
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8)
                       for i in range(256)])
    return tables


_CRC32C_T = _crc32c_tables()


def crc32c(data, init: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected 0x82F63B78 — iSCSI / RFC 3720).
    ``init`` is a previous crc32c() result, so checksums stream across
    chunk boundaries like zlib.crc32's running form."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC32C_T
    buf = bytes(data)
    crc = init ^ 0xFFFFFFFF
    n = len(buf)
    i = 0
    # slice-by-8: one combined table step per 8 bytes
    for i in range(0, n - 7, 8):
        crc ^= int.from_bytes(buf[i:i + 4], "little")
        hi = int.from_bytes(buf[i + 4:i + 8], "little")
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
               ^ t1[(hi >> 16) & 0xFF] ^ t0[(hi >> 24) & 0xFF])
    for j in range(n - (n % 8), n):
        crc = t0[(crc ^ buf[j]) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def gettimeofday_us() -> int:
    return time.time_ns() // 1000


def monotonic_time_ns() -> int:
    return time.monotonic_ns()


def cpuwide_time_us() -> int:
    return time.perf_counter_ns() // 1000


class Timer:
    """Scoped stopwatch (butil::Timer)."""

    def __init__(self):
        self._start = 0
        self._stop = 0

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        self._stop = time.perf_counter_ns()

    def n_elapsed(self) -> int:
        return self._stop - self._start

    def u_elapsed(self) -> int:
        return self.n_elapsed() // 1000

    def m_elapsed(self) -> int:
        return self.n_elapsed() // 1000000


def u24(b, off: int = 0) -> int:
    """Read a 24-bit big-endian integer (RTMP/FLV tag headers)."""
    return (b[off] << 16) | (b[off + 1] << 8) | b[off + 2]


def p24(v: int) -> bytes:
    """Pack a 24-bit big-endian integer."""
    return bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))
