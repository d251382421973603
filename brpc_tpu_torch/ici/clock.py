"""Per-peer clock alignment for cross-process span stitching.

Port of :mod:`brpc_tpu.ici.clock`.  Span clocks are per process:
``monotonic_ns`` timelines of two processes cannot be compared, and wall
clocks on two hosts drift.  Each fabric socket pair therefore estimates
its peer's wall-clock offset with one NTP-style exchange piggybacked on
the HELLO/HELLO_OK handshake itself (``FabricNode.connect`` stamps its
wall ``t0`` into the HELLO json; the server side echoes it with its own
wall in the HELLO_OK body), with no control frame of its own:

    t0 = local wall at HELLO send        (monotonic stamp kept alongside)
    pw = peer wall stamped into HELLO_OK (echoing t0)
    t1 = local monotonic at HELLO_OK receipt

    rtt        = t1 - t0 (monotonic)
    offset_us  = pw - (t0 + rtt/2)       # peer_wall - local_wall estimate
    bound_us   = rtt/2                   # the estimate's error bound

The peer stamped ``pw`` inside the [t0, t1] window, so the true offset
lies within ±rtt/2 of the estimate: cross-process span order derived from
it is explicit and bounded.  The table keeps the tightest-bound sample per
peer (a re-probe on a later socket can only improve it), unless the kept
one is stale.

Consumers: the pod-scope ``/rpcz`` stitcher
(:mod:`..rpc.builtin.pod_scope`) maps a remote span's wall anchor into
local time as ``remote_wall - offset_us`` and reports ``bound_us`` with
every aligned timestamp.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
# pid -> (offset_us, bound_us, recorded_monotonic); samples arrive from
# every fabric socket's handshake concurrently
_peers: Dict[int, Tuple[float, float, float]] = {}

# a sample this old is replaced even by a looser-bound fresh one (drift
# over hours would otherwise hide behind one lucky tight probe)
_STALE_S = 600.0

# Samples are taken only at HELLO time, so on a long-lived socket pair the
# estimate ages with no re-probe; the reported bound widens by an
# age-proportional drift allowance so it stays honest (~20 ppm covers
# typical unsynced crystal drift).  Reconnects refresh the sample.
_DRIFT_US_PER_S = 20.0


def record(pid: int, offset_us: float, bound_us: float) -> None:
    """Record one offset sample for ``pid``; keeps the tightest-bound
    non-stale sample."""
    now = time.monotonic()
    with _lock:
        prev = _peers.get(pid)
        if prev is not None and now - prev[2] < _STALE_S \
                and prev[1] + (now - prev[2]) * _DRIFT_US_PER_S \
                <= bound_us:
            # the previous sample, drift-aged, is still tighter
            return
        _peers[pid] = (float(offset_us), float(bound_us), now)


def offset(pid: int) -> Optional[Tuple[float, float]]:
    """(offset_us, bound_us) for ``pid`` — peer_wall minus local_wall —
    or None when no fabric exchange has sampled that peer yet.  The bound
    includes the age-proportional drift allowance."""
    with _lock:
        entry = _peers.get(pid)
    if entry is None:
        return None
    age_s = max(0.0, time.monotonic() - entry[2])
    return entry[0], entry[1] + age_s * _DRIFT_US_PER_S


def to_local_wall_us(pid: int, remote_wall_us: float) -> Tuple[float, float]:
    """Map a remote process's wall timestamp onto the local wall axis:
    (aligned_us, bound_us).  Unknown peers pass through with bound -1
    (same-host wall clocks are the unrefined fallback)."""
    entry = offset(pid)
    if entry is None:
        return float(remote_wall_us), -1.0
    return float(remote_wall_us) - entry[0], entry[1]


def describe() -> Dict[str, dict]:
    with _lock:
        snap = dict(_peers)
    now = time.monotonic()
    return {str(pid): {"offset_us": round(off, 1),
                       "bound_us": round(bound, 1),
                       "age_s": round(now - at, 1)}
            for pid, (off, bound, at) in snap.items()}


def reset_for_test() -> None:
    with _lock:
        _peers.clear()
