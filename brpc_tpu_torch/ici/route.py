"""Payload routes and the plane-health event counters.

Port of the plane-event half of :mod:`brpc_tpu.ici.route`: the one
counter family every plane's health transitions tick, ``<plane>_<event>``,
where the event is

  * ``down``     UP -> DOWN, counted once per transition;
  * ``reprobe``  one revival attempt (a lapsed timer latch);
  * ``revived``  back UP;
  * ``ramp``     the first use that clears the half-open gate after a
                 revival.

Only :class:`~.plane_health.PlaneHealth` records these.  The route and
payload-class names, the route table (``candidates``), its per-route byte
counters and the collective route wait for the fabric's planes, which are
not ported.
"""
from __future__ import annotations

import threading
from typing import Dict

from .. import bvar

_lock = threading.Lock()
_plane_events: Dict[str, bvar.Adder] = {}


def record_plane(name: str, event: str, n: int = 1) -> None:
    """Count one plane-health event (``down``/``reprobe``/``revived``/
    ``ramp``) for plane ``name``."""
    label = f"{name}_{event}"
    adder = _plane_events.get(label)
    if adder is None:
        with _lock:
            adder = _plane_events.get(label)
            if adder is None:
                adder = _plane_events[label] = bvar.Adder(
                    f"rpc_fabric_plane_{label}")
    adder << n


def plane_stats() -> Dict[str, int]:
    """``{"<plane>_<event>": count}`` for every event recorded so far."""
    with _lock:
        items = list(_plane_events.items())
    return {label: a.get_value() for label, a in items}
