"""Circuit breaker + cluster recover policy.

Port of :mod:`brpc_tpu.rpc.circuit_breaker`.  Reference: src/brpc/circuit_breaker.h:25-85 (EMA error windows, doubling
isolation) and cluster_recover_policy.h:39-82 (don't stampede a shrunken
cluster).  A breaker per endpoint tracks short/long EMA error rates; when
either trips, the node is isolated for ``isolation_duration`` (doubling up
to a cap on repeated trips, halving back after quiet recovery).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..butil.endpoint import EndPoint
from ..butil import flags as _flags

_flags.define_flag("circuit_breaker_short_window_size", 30,
                   "samples in the short EMA window", _flags.positive_integer)
_flags.define_flag("circuit_breaker_long_window_size", 300,
                   "samples in the long EMA window", _flags.positive_integer)
_flags.define_flag("circuit_breaker_max_error_rate", 0.5,
                   "short-window error rate that trips the breaker")
_flags.define_flag("circuit_breaker_long_error_rate", 0.2,
                   "long-window error rate that trips the breaker")
_flags.define_flag("circuit_breaker_min_isolation_duration_ms", 100,
                   "first isolation duration", _flags.positive_integer)
_flags.define_flag("circuit_breaker_max_isolation_duration_ms", 30000,
                   "isolation duration cap", _flags.positive_integer)


class CircuitBreaker:
    def __init__(self):
        self._short_ema = 0.0
        self._long_ema = 0.0
        self._short_alpha = 1.0 / _flags.get_flag(
            "circuit_breaker_short_window_size")
        self._long_alpha = 1.0 / _flags.get_flag(
            "circuit_breaker_long_window_size")
        self._lock = threading.Lock()
        self._isolated_until = 0.0
        self._isolation_ms = _flags.get_flag(
            "circuit_breaker_min_isolation_duration_ms")
        self._samples = 0

    def on_call_end(self, error_code: int) -> bool:
        """Record a call; returns False if this call TRIPPED the breaker."""
        err = 1.0 if error_code != 0 else 0.0
        with self._lock:
            self._samples += 1
            self._short_ema += self._short_alpha * (err - self._short_ema)
            self._long_ema += self._long_alpha * (err - self._long_ema)
            if self._samples < 5:
                return True
            if (self._short_ema > _flags.get_flag("circuit_breaker_max_error_rate")
                    or self._long_ema > _flags.get_flag(
                        "circuit_breaker_long_error_rate")):
                now = time.monotonic()
                if now >= self._isolated_until:
                    self._isolated_until = now + self._isolation_ms / 1000.0
                    self._isolation_ms = min(
                        self._isolation_ms * 2,
                        _flags.get_flag("circuit_breaker_max_isolation_duration_ms"))
                    self._short_ema = 0.0   # start fresh after isolation
                    self._samples = 0
                return False
            return True

    def is_isolated(self) -> bool:
        with self._lock:
            return time.monotonic() < self._isolated_until

    def isolated_until(self) -> float:
        with self._lock:
            return self._isolated_until

    def mark_recovered(self) -> None:
        with self._lock:
            self._isolated_until = 0.0
            self._isolation_ms = max(
                self._isolation_ms // 2,
                _flags.get_flag("circuit_breaker_min_isolation_duration_ms"))
            self._short_ema = self._long_ema = 0.0
            self._samples = 0


class ClusterRecoverPolicy:
    """Refuse to dogpile a cluster that shrank below min_working_instances
    (cluster_recover_policy.h)."""

    def __init__(self, min_working_instances: int = 1,
                 hold_seconds: float = 2.0):
        self.min_working = min_working_instances
        self.hold_seconds = hold_seconds
        self._recovering_since: Optional[float] = None
        self._lock = threading.Lock()

    def on_cluster_size(self, working: int, total: int) -> bool:
        """True → cluster usable; False → in recovery hold-off (callers
        should fail fast instead of stampeding)."""
        with self._lock:
            if working >= max(self.min_working, 1):
                self._recovering_since = None
                return True
            now = time.monotonic()
            if self._recovering_since is None:
                self._recovering_since = now
                return False
            return (now - self._recovering_since) >= self.hold_seconds


class BreakerRegistry:
    _instance = None
    _ilock = threading.Lock()

    def __init__(self):
        self._map: Dict[EndPoint, CircuitBreaker] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "BreakerRegistry":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = BreakerRegistry()
            return cls._instance

    def breaker(self, ep: EndPoint) -> CircuitBreaker:
        with self._lock:
            b = self._map.get(ep)
            if b is None:
                b = CircuitBreaker()
                self._map[ep] = b
            return b
