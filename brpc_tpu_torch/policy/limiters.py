"""Concurrency limiters, ported from :mod:`brpc_tpu.policy.limiters`
(reference: src/brpc/policy/ — constant,
auto_concurrency_limiter.{h,cpp}, timeout_concurrency_limiter.{h,cpp};
interface concurrency_limiter.h:29-44).

* Constant: fixed max concurrent requests.
* Auto: the reference's GRADIENT limiter (docs/cn/
  auto_concurrency_limiter.md): latency/qps are aggregated over sampling
  windows, the no-load latency floor is learned by a noise-filtered EMA
  of window averages (plus periodic forced exploration windows that
  shrink concurrency so the floor can be re-measured under light load),
  and the limit follows the documented gradient formula

      max_concurrency = max_qps × ((2 + alpha) × min_latency − latency)

  which equals peak_qps × min_latency × (1 + alpha) at the knee (Little's
  law with headroom) and walks the limit DOWN linearly as sampled latency
  inflates past the floor.
* Timeout: admit while expected queueing delay stays under the deadline.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class ConcurrencyLimiter:
    def on_requested(self, current_concurrency: int) -> bool:
        raise NotImplementedError

    def on_responded(self, error_code: int, latency_us: int) -> None:
        pass

    def max_concurrency(self) -> int:
        raise NotImplementedError


class ConstantConcurrencyLimiter(ConcurrencyLimiter):
    def __init__(self, max_concurrency: int):
        self._max = max_concurrency

    def on_requested(self, current_concurrency: int) -> bool:
        return current_concurrency < self._max

    def max_concurrency(self) -> int:
        return self._max


class AutoConcurrencyLimiter(ConcurrencyLimiter):
    """The reference gradient algorithm (auto_concurrency_limiter.cpp,
    re-derived from docs/cn/auto_concurrency_limiter.md — the C++ source
    is not vendored here):

      * samples aggregate into windows of [min_sample_count,
        max_sample_count] responses spanning at least sample_window_us;
      * failed responses contribute fail_punish_ratio × their latency to
        the window's latency mass but not to its success count;
      * min_latency (the no-load floor) moves by EMA only when a window
        beats it, and drifts up very slowly otherwise so a genuinely
        changed baseline re-converges (noise filtering);
      * max_qps rises instantly to any observed peak and decays by a
        slow EMA;
      * every remeasure_interval_us the limiter forces an EXPLORATION
        window: concurrency drops to reduce_ratio × (max_qps ×
        min_latency) and the floor is re-seeded from what it measures —
        without this, a floor learned under load never falls back;
      * otherwise: max_concurrency = max_qps × ((2 + alpha) ×
        min_latency − latency), floored at MIN_LIMIT.

    Timestamps are injectable (``add_sample(..., now_us=...)``) so the
    convergence tests drive a simulated clock deterministically."""

    EMA_FACTOR = 0.1
    ALPHA = 0.3                  # acceptable latency headroom above floor
    FAIL_PUNISH_RATIO = 1.0
    REDUCE_RATIO_WHILE_REMEASURE = 0.9
    MIN_LIMIT = 4

    def __init__(self, initial: int = 40,
                 sample_window_us: int = 100_000,
                 min_sample_count: int = 20,
                 max_sample_count: int = 200,
                 remeasure_interval_us: int = 5_000_000):
        self._max = initial
        self._lock = threading.Lock()
        self._sample_window_us = sample_window_us
        self._min_sample_count = min_sample_count
        self._max_sample_count = max_sample_count
        self._remeasure_interval_us = remeasure_interval_us
        self._win_start_us: Optional[int] = None
        self._win_succ_us = 0
        self._win_fail_us = 0
        self._win_succ = 0
        self._win_fail = 0
        self.min_latency_us: Optional[float] = None
        self.max_qps = 0.0
        self._next_remeasure_us: Optional[int] = None
        self._remeasuring = False
        self.remeasure_count = 0     # exploration windows run (test hook)

    def on_requested(self, current_concurrency: int) -> bool:
        return current_concurrency < self._max

    def on_responded(self, error_code: int, latency_us: int) -> None:
        self.add_sample(error_code, latency_us,
                        time.monotonic_ns() // 1000)

    def add_sample(self, error_code: int, latency_us: int,
                   now_us: int) -> None:
        with self._lock:
            if self._win_start_us is None:
                self._win_start_us = now_us
                self._next_remeasure_us = (self._next_remeasure_us
                                           or now_us
                                           + self._remeasure_interval_us)
            if error_code == 0:
                self._win_succ += 1
                self._win_succ_us += latency_us
            else:
                self._win_fail += 1
                self._win_fail_us += latency_us
            total = self._win_succ + self._win_fail
            span = now_us - self._win_start_us
            if total < self._max_sample_count and (
                    span < self._sample_window_us
                    or total < self._min_sample_count):
                return
            if self._win_succ == 0:
                # an all-error window teaches nothing about latency:
                # shrink defensively and restart the window
                self._max = max(self._max // 2, self.MIN_LIMIT)
                self._reset_window(now_us)
                return
            punished = (self._win_succ_us
                        + self.FAIL_PUNISH_RATIO * self._win_fail_us)
            avg_latency = punished / self._win_succ
            qps = 1e6 * self._win_succ / max(span, 1)
            self._update_min_latency(avg_latency)
            self._update_max_qps(qps)
            if self._remeasuring:
                # exploration done: the floor was re-seeded from a
                # lightly-loaded window; restore the gradient limit
                self._remeasuring = False
                self._max = self._gradient_limit(avg_latency)
            elif self._next_remeasure_us is not None \
                    and now_us >= self._next_remeasure_us:
                # periodic forced exploration: drop concurrency BELOW
                # the knee so the next window samples the no-load floor
                # — sized from the FLOOR (max_qps × min_latency is the
                # knee by Little's law), not from the loaded avg_latency,
                # which under steady overload sits above the knee and
                # would leave the "exploration" window still saturated
                self.remeasure_count += 1
                self._remeasuring = True
                ideal = self.max_qps * (
                    (self.min_latency_us or avg_latency) / 1e6)
                self.min_latency_us = None       # re-learn from scratch
                self._next_remeasure_us = (now_us
                                           + self._remeasure_interval_us)
                self._max = max(
                    int(ideal * self.REDUCE_RATIO_WHILE_REMEASURE),
                    self.MIN_LIMIT)
            else:
                self._max = self._gradient_limit(avg_latency)
            self._reset_window(now_us)

    def _reset_window(self, now_us: int) -> None:
        self._win_start_us = now_us
        self._win_succ = self._win_fail = 0
        self._win_succ_us = self._win_fail_us = 0

    def _update_min_latency(self, avg_latency: float) -> None:
        if self.min_latency_us is None:
            self.min_latency_us = avg_latency
        elif avg_latency < self.min_latency_us:
            # noise filter: move toward a better floor by EMA, never jump
            self.min_latency_us += self.EMA_FACTOR * (
                avg_latency - self.min_latency_us)
        else:
            # very slow upward drift: a permanently slower baseline
            # eventually wins without letting one bad window poison the
            # floor
            self.min_latency_us *= 1.001

    def _update_max_qps(self, qps: float) -> None:
        if qps > self.max_qps:
            self.max_qps = qps
        else:
            self.max_qps += (self.EMA_FACTOR / 10.0) * (qps - self.max_qps)

    def _gradient_limit(self, avg_latency: float) -> int:
        floor = self.min_latency_us or avg_latency
        next_max = self.max_qps / 1e6 * ((2.0 + self.ALPHA) * floor
                                         - avg_latency)
        return max(int(next_max), self.MIN_LIMIT)

    def max_concurrency(self) -> int:
        return self._max


class TimeoutConcurrencyLimiter(ConcurrencyLimiter):
    """Admit while estimated queue wait < timeout budget
    (timeout_concurrency_limiter.cpp)."""

    def __init__(self, timeout_ms: float = 500.0):
        self._timeout_ms = timeout_ms
        self._avg_latency_us = 1000.0
        self._lock = threading.Lock()

    def on_requested(self, current_concurrency: int) -> bool:
        with self._lock:
            expected_wait_ms = current_concurrency * self._avg_latency_us / 1000.0
            return expected_wait_ms < self._timeout_ms

    def on_responded(self, error_code: int, latency_us: int) -> None:
        if error_code == 0:
            with self._lock:
                self._avg_latency_us = (self._avg_latency_us * 0.9
                                        + latency_us * 0.1)

    def max_concurrency(self) -> int:
        with self._lock:
            return max(int(self._timeout_ms * 1000 / max(self._avg_latency_us, 1)), 1)
