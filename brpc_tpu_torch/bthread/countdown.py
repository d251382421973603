"""CountdownEvent (reference: src/bthread/countdown_event.{h,cpp})."""
from __future__ import annotations

from typing import Optional

from .butex import Butex, ETIMEDOUT


class CountdownEvent:
    def __init__(self, initial_count: int = 1):
        if initial_count < 0:
            raise ValueError("negative count")
        self._butex = Butex(initial_count)

    def signal(self, sig: int = 1) -> None:
        b = self._butex
        with b._cond:
            if b._value <= 0:
                return
            b._value -= sig
            if b._value <= 0:
                b._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> int:
        b = self._butex
        import time
        from . import scheduler
        with b._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            scheduler.note_worker_blocked()
            try:
                while b._value > 0:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return ETIMEDOUT
                    b._cond.wait(remaining)
                return 0
            finally:
                scheduler.note_worker_unblocked()

    def add_count(self, v: int = 1) -> None:
        with self._butex._cond:
            self._butex._value += v

    def reset(self, v: int) -> None:
        self._butex.set_value(v)
