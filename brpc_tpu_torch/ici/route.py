"""Payload routes and the plane-health event counters.

Port of the plane-event half of :mod:`brpc_tpu.ici.route`: the one
counter family every plane's health transitions tick, ``<plane>_<event>``,
where the event is

  * ``down``     UP -> DOWN, counted once per transition;
  * ``reprobe``  one revival attempt (a lapsed timer latch);
  * ``revived``  back UP;
  * ``ramp``     the first use that clears the half-open gate after a
                 revival.

Only :class:`~.plane_health.PlaneHealth` records these.

The collective route (:mod:`..channels.collective_fanout`) is not a byte
mover, so it is no row of a route table: what this module keeps for it is
its event counters, ``collective_<event>[_<reason>]`` (``selected``,
``ineligible_<reason>``, ``degraded_<reason>``, ``revived_<reason>``,
``slot_timeout``), exposed as ``rpc_fabric_route_collective_...``.  The
route and payload-class names, the route table (``candidates``) and its
per-route byte counters wait for the fabric's planes, which are not
ported.
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


_collective_events: Dict[str, bvar.Adder] = {}


def record_collective(event: str, reason: str = "", n: int = 1) -> None:
    """Count one collective-route event (``selected``, ``degraded``,
    ``revived``, ``ineligible``, ``slot_timeout``), with an optional
    reason suffix."""
    label = f"collective_{event}" + (f"_{reason}" if reason else "")
    adder = _collective_events.get(label)
    if adder is None:
        with _lock:
            adder = _collective_events.get(label)
            if adder is None:
                adder = _collective_events[label] = bvar.Adder(
                    f"rpc_fabric_route_{label}")
    adder << n


def collective_stats() -> Dict[str, int]:
    """``{"collective_<event>[_<reason>]": count}`` for the /ici page and
    the route assertions."""
    with _lock:
        items = list(_collective_events.items())
    return {label: a.get_value() for label, a in items}
