"""The client's backoff after an admission shed.

Of :mod:`brpc_tpu.rpc.admission` the port keeps one function: the delay a
caller waits before retrying an ``ELIMIT`` shed that carried a
``retry_after_ms`` hint.  The admission queue itself is not ported.
"""
from __future__ import annotations

import random


def shed_backoff_s(hint_ms: int, seed=None) -> float:
    """The server's ``retry_after_ms`` hint plus 0-25 % jitter ABOVE it,
    never below: shed callers re-arriving at the same instant are the
    synchronized storm the hint exists to prevent.  ``seed`` makes the
    jitter deterministic per (call, try); None draws from the process
    generator."""
    rng = random.Random(seed) if seed is not None else random
    return hint_ms * (1.0 + 0.25 * rng.random()) / 1000.0
