"""IntRecorder, Percentile and LatencyRecorder.

Reference: src/bvar/latency_recorder.h and detail/percentile.{h,cpp},
ported from :mod:`brpc_tpu.bvar.latency_recorder`.  Percentiles keep the
reference's per-thread reservoirs (254 samples an agent) combined on read;
a reservoir's replacement draws come from ``butil.misc.fast_rand``, so a
thread seeded with ``seed_fast_rand`` draws the same slots as the JAX
package's generator seeded alike.  LatencyRecorder is the compound variable
every method status and tpu_std stage exposes: latency (mean), max, count,
qps and the 50/80/90/99/99.9/99.99 percentiles over a sliding window.

A record sits on every request's accounting path.  Under
``bvar_batched_record`` (default on) a thread's five agents share one lock,
so a record is one acquisition; readers take each agent's own lock, which
is then the same object five times.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from ..butil import flags as _flags
from ..butil.misc import fast_rand_less_than
from .variable import Variable, PassiveStatus
from .reducer import Adder, Maxer, Reducer
from .window import PerSecond, _ReducerSampler, SamplerCollector

_SAMPLES_PER_AGENT = 254        # reference: PercentileInterval<254>

_flags.define_flag(
    "bvar_batched_record", True,
    "record LatencyRecorder samples under ONE shared per-thread lock "
    "(five agents, one acquisition) instead of five per-agent locks")


class _PercentileSample:
    """A fixed-size reservoir of latency samples (detail/percentile.h)."""

    __slots__ = ("samples", "num_added")

    def __init__(self):
        self.samples: List[int] = []
        self.num_added = 0

    def add(self, value: int) -> None:
        self.num_added += 1
        if len(self.samples) < _SAMPLES_PER_AGENT:
            self.samples.append(value)
        else:
            i = fast_rand_less_than(self.num_added)
            if i < _SAMPLES_PER_AGENT:
                self.samples[i] = value

    def merge(self, other: "_PercentileSample") -> "_PercentileSample":
        out = _PercentileSample()
        out.num_added = self.num_added + other.num_added
        combined = self.samples + other.samples
        if len(combined) <= _SAMPLES_PER_AGENT:
            out.samples = combined
        else:
            # weightless downsample (CombineOf in percentile.h)
            out.samples = [combined[fast_rand_less_than(len(combined))]
                           for _ in range(_SAMPLES_PER_AGENT)]
        return out

    def get_number(self, ratio: float) -> int:
        if not self.samples:
            return 0
        s = sorted(self.samples)
        idx = min(int(ratio * len(s)), len(s) - 1)
        return s[idx]


def _merge_samples(a: _PercentileSample,
                   b: _PercentileSample) -> _PercentileSample:
    return a.merge(b)


class Percentile(Reducer):
    """A reducer of reservoirs: ``p << us`` records one sample."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(_PercentileSample(), _merge_samples, None, name)

    def __lshift__(self, latency: int) -> "Percentile":
        a = self._agent()
        with a.lock:
            if a.value is self._identity:
                a.value = _PercentileSample()
            a.value.add(int(latency))
        return self

    def _agent(self, lock=None):
        a = getattr(self._tls, "agent", None)
        if a is None:
            a = super()._agent(lock)
            a.value = _PercentileSample()
        return a

    def version(self) -> tuple:
        """Changes whenever a sample is added or a reservoir replaced:
        the window sampler skips re-merging an unchanged reducer."""
        with self._agents_lock:
            agents = list(self._agents)
        return tuple((id(a.value), a.value.num_added) for a in agents)

    def get_value(self) -> _PercentileSample:
        result = _PercentileSample()
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                result = result.merge(a.value)
        return result

    def describe(self) -> str:
        s = self.get_value()
        return (f"p50={s.get_number(0.5)} p99={s.get_number(0.99)} "
                f"n={s.num_added}")


class IntRecorder(Variable):
    """The average of recorded ints (reference bvar::IntRecorder), kept as
    a write-local (sum, count)."""

    def __init__(self, name: Optional[str] = None):
        self._sum = Adder()
        self._count = Adder()
        # this thread's two agents, made sharing one lock on the first
        # record: a record is one tls load and one acquisition
        self._tls = threading.local()
        super().__init__(name)

    def __lshift__(self, value: int) -> "IntRecorder":
        value = int(value)
        try:
            s, c = self._tls.agents
        except AttributeError:
            lock = threading.Lock()
            s, c = self._tls.agents = (self._sum._agent(lock),
                                       self._count._agent(lock))
        if s.lock is c.lock:
            with s.lock:
                s.value += value
                c.value += 1
        else:                       # an agent made earlier keeps its lock
            with s.lock:
                s.value += value
            with c.lock:
                c.value += 1
        return self

    def average(self) -> float:
        c = self._count.get_value()
        return self._sum.get_value() / c if c else 0.0

    def get_value(self):
        return self.average()

    def sum(self) -> int:
        return self._sum.get_value()

    def count(self) -> int:
        return self._count.get_value()


class LatencyRecorder(Variable):
    """The compound latency/qps variable (latency_recorder.h): ``rec <<
    us`` records one call's latency in microseconds.  Exposed under
    ``prefix`` as ``<prefix>_latency``, ``_max_latency``, ``_count``,
    ``_qps`` and ``_latency_<50|80|90|99|999|9999>``."""

    def __init__(self, prefix: Optional[str] = None, window_size: int = 10):
        self._latency = IntRecorder()
        self._max_latency = Maxer()
        self._count = Adder()
        self._qps_window = PerSecond(self._count, window_size)
        self._percentile = Percentile()
        self._win_percentile = _WindowedPercentile(self._percentile,
                                                   window_size)
        # this thread's five agents, resolved once (one tls load a record)
        self._tls_fast = threading.local()
        super().__init__(None)
        if prefix:
            self.expose(prefix)

    def expose(self, prefix: str, _ignored: str = "") -> bool:
        ok = super().expose(prefix + "_latency")
        self._max_latency.expose(prefix + "_max_latency")
        self._count.expose(prefix + "_count")
        self._qps_window.expose(prefix + "_qps")
        self._win_percentile.expose_percentiles(prefix)
        return ok

    def _bind_agents(self):
        """Resolve this thread's five agents once.  Batched mode creates
        them sharing one lock; if any agent existed already with its own
        lock, the tuple falls back to per-agent locking."""
        if _flags.get_flag("bvar_batched_record"):
            lock = threading.Lock()
            s = self._latency._sum._agent(lock)
            c = self._latency._count._agent(lock)
            m = self._max_latency._agent(lock)
            n = self._count._agent(lock)
            p = self._percentile._agent(lock)
            if (s.lock is c.lock and c.lock is m.lock
                    and m.lock is n.lock and n.lock is p.lock):
                return (s.lock, s, c, m, n, p, self._percentile._identity)
            return (None, s, c, m, n, p, self._percentile._identity)
        return (None, self._latency._sum._agent(),
                self._latency._count._agent(),
                self._max_latency._agent(), self._count._agent(),
                self._percentile._agent(), self._percentile._identity)

    def __lshift__(self, latency_us: int) -> "LatencyRecorder":
        latency_us = int(latency_us)
        tls = self._tls_fast
        ag = getattr(tls, "agents", None)
        if ag is None:
            ag = tls.agents = self._bind_agents()
        lock, s, c, m, n, p, pident = ag
        if lock is not None:
            with lock:
                s.value += latency_us
                c.value += 1
                if latency_us > m.value:
                    m.value = latency_us
                n.value += 1
                v = p.value
                if v is pident:
                    v = p.value = _PercentileSample()
                v.add(latency_us)
            return self
        with s.lock:
            s.value += latency_us
        with c.lock:
            c.value += 1
        with m.lock:
            if latency_us > m.value:
                m.value = latency_us
        with n.lock:
            n.value += 1
        with p.lock:
            v = p.value
            if v is pident:
                v = p.value = _PercentileSample()
            v.add(latency_us)
        return self

    # reads ------------------------------------------------------------
    def get_value(self):
        return self.latency()

    def latency(self) -> float:
        return self._latency.average()

    def max_latency(self) -> int:
        return self._max_latency.get_value()

    def count(self) -> int:
        return self._count.get_value()

    def qps(self) -> float:
        return self._qps_window.get_value()

    def latency_percentile(self, ratio: float) -> int:
        return self._win_percentile.percentile(ratio)


class _WindowedPercentile:
    """A window over a Percentile reducer, exposing pNN PassiveStatus
    variables."""

    def __init__(self, percentile: Percentile, window_size: int):
        self._sampler = _ReducerSampler(percentile, window_size)
        self._sampler.take_sample()
        SamplerCollector.instance().register(self._sampler)
        self._window_size = window_size
        self._exposed: List[Variable] = []

    def percentile(self, ratio: float) -> int:
        v, _ = self._sampler.value_in_window(self._window_size)
        return v.get_number(ratio)

    def expose_percentiles(self, prefix: str) -> None:
        for tag, ratio in (("50", .5), ("80", .8), ("90", .9),
                           ("99", .99), ("999", .999), ("9999", .9999)):
            self._exposed.append(PassiveStatus(
                lambda r=ratio: self.percentile(r),
                f"{prefix}_latency_{tag}"))
