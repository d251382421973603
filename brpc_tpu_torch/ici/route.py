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
``slot_timeout``), exposed as ``rpc_fabric_route_collective_...``.

The socket half, trimmed to the fabric's two routes: ``device`` (the
sequenced device plane, kind 4: the receiver pulls the row) and ``inline``
(bytes in the control frame, kind 0).  :func:`candidates` orders them for
one payload and :func:`record` counts each frame in
``rpc_fabric_route_<route>_frames`` / ``_bytes``.  The JAX package's
``shm``, ``bulk`` and ``xfer`` rows wait for those planes.
"""
from __future__ import annotations

import threading
from typing import Dict, List

from .. import bvar

_lock = threading.Lock()

DEVICE = "device"      # a route, and the class of DEVICE-block payloads
INLINE = "inline"


def candidates(sock, cls: str, nbytes: int) -> List[str]:
    """Ordered routes for one payload on fabric socket ``sock``.  A DEVICE
    payload the device plane must carry gets that route alone: a refused
    post fails the write, nothing falls through to inline.  Anything else
    rides inline."""
    if cls == DEVICE and sock.dplane_eligible(nbytes):
        return [DEVICE]
    return [INLINE]


_route_counters: Dict[str, tuple] = {}


def record(sock, route: str, nbytes: int, frames: int = 1) -> None:
    """Count ``frames`` frame(s) of ``nbytes`` on ``route``."""
    pair = _route_counters.get(route)
    if pair is None:
        with _lock:
            pair = _route_counters.get(route)
            if pair is None:
                pair = _route_counters[route] = (
                    bvar.Adder(f"rpc_fabric_route_{route}_frames"),
                    bvar.Adder(f"rpc_fabric_route_{route}_bytes"))
    pair[0] << frames
    pair[1] << nbytes


def route_stats() -> Dict[str, int]:
    """``{"<route>_frames": n, "<route>_bytes": n}`` so far."""
    with _lock:
        items = list(_route_counters.items())
    out: Dict[str, int] = {}
    for route, (frames, nbytes) in items:
        out[f"{route}_frames"] = frames.get_value()
        out[f"{route}_bytes"] = nbytes.get_value()
    return out

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
