"""Per-method accounting: concurrency, qps, latency, errors.

Port of :mod:`brpc_tpu.rpc.method_status` (reference:
src/brpc/details/method_status.{h,cpp}): every server method owns a
MethodStatus that its concurrency limiter consults (OnRequested /
OnResponded) and ``describe()`` renders.
"""
from __future__ import annotations

import threading

from .. import bvar
from . import errors

# Admission-layer rejection codes: shed traffic, not method failures.
# Feeding these into AutoConcurrencyLimiter.add_sample would have
# FAIL_PUNISH_RATIO treat every shed as a slow failure — under overload
# (exactly when sheds are plentiful) the punished latency mass poisons
# the learned no-load floor and walks the limit down, amplifying the
# overload it should absorb.  They are also excluded from the per-method
# error count (the method never ran) and tracked in their own counter.
#
# Scope note: gate/admission rejections null `status` before responding
# and never reach on_responded at all — what this classification ALSO
# covers is an EXECUTED handler that completes with ELIMIT/ELOGOFF (a
# proxy propagating a downstream shed, a handler bouncing during its own
# drain).  That is deliberate: punishing the LOCAL limiter's floor for a
# DOWNSTREAM's overload would collapse local concurrency exactly when
# the downstream is shedding, and a go-elsewhere signal is not a failure
# of this method.  Such completions stay visible in shed_count.
SHED_CODES = frozenset((errors.ELIMIT, errors.ELOGOFF))


class MethodStatus:
    def __init__(self, full_name: str, limiter=None):
        safe = bvar.to_underscored_name(full_name)
        self.full_name = full_name
        self.latency_rec = bvar.LatencyRecorder(f"rpc_method_{safe}")
        self.error_count = bvar.Adder(f"rpc_method_{safe}_error")
        self.shed_count = bvar.Adder(f"rpc_method_{safe}_shed")
        # every request of this method the server parsed a frame for,
        # bounced, shed or run: each one's attachment crossed the
        # transport
        self.received = bvar.Adder(f"rpc_method_{safe}_received")
        self._concurrency = 0
        self._lock = threading.Lock()
        self.limiter = limiter          # ConcurrencyLimiter or None

    def on_requested(self) -> bool:
        """False → reject with ELIMIT (limiter says no)."""
        with self._lock:
            if self.limiter is not None and not self.limiter.on_requested(
                    self._concurrency):
                return False
            self._concurrency += 1
            return True

    def on_responded(self, error_code: int, latency_us: int) -> None:
        with self._lock:
            self._concurrency -= 1
        if error_code == 0:
            self.latency_rec << latency_us
        elif error_code in SHED_CODES:
            # admission shed / lame-duck bounce: not a method failure,
            # and NOT a limiter sample (see SHED_CODES above)
            self.shed_count << 1
            return
        else:
            self.error_count << 1
        if self.limiter is not None:
            self.limiter.on_responded(error_code, latency_us)

    @property
    def concurrency(self) -> int:
        return self._concurrency

    def describe(self) -> dict:
        return {
            "method": self.full_name,
            "count": self.latency_rec.count(),
            "qps": round(self.latency_rec.qps(), 2),
            "latency_us": round(self.latency_rec.latency(), 1),
            "max_latency_us": self.latency_rec.max_latency(),
            "concurrency": self.concurrency,
            "errors": self.error_count.get_value(),
            "shed": self.shed_count.get_value(),
            "received": self.received.get_value(),
        }
