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

The socket half: :func:`candidates` orders the routes for one payload and
:func:`record` counts each frame in ``rpc_fabric_route_<route>_frames`` /
``_bytes``, the ``bulk`` row labelled ``uds`` or ``tcp`` by how the
socket's bulk conn was dialed; :func:`record_shm_stripe` counts a striped
ring's frames per stripe.  Routes, fastest first for a same-host pair:

  device  the sequenced device plane (kind 4: the receiver pulls the row);
  shm     the mmap'd ring (kinds 5/6): one sender copy, zero-copy claim;
  bulk    the pair's dedicated socket conn (kinds 2/3);
  inline  the bytes in the control frame (kind 0).

The JAX package's ``xfer`` row (the transfer server, kind 1) is not
ported.  The port differs from the JAX table in one place: a DEVICE
payload the device plane must carry gets that route alone, so a refused
post fails the write instead of moving the bytes another way.
"""
from __future__ import annotations

import threading
from typing import Dict, List

from .. import bvar
from ..butil import flags as _flags

_lock = threading.Lock()

DEVICE = "device"      # a route, and the class of DEVICE-block payloads
SHM = "shm"
BULK = "bulk"
INLINE = "inline"
HOST = "host"          # joined host byte blobs (kinds 0/3/6)
STREAM = "stream"      # stream DATA frames (frames 5-7)


def candidates(sock, cls: str, nbytes: int) -> List[str]:
    """Ordered routes for one payload on fabric socket ``sock``; the
    caller tries them in order, and a route that fails mid-frame degrades
    its plane and falls through to the next.  A DEVICE payload the device
    plane must carry gets ``[DEVICE]`` alone.  Otherwise the JAX package's
    list: below its class threshold a payload rides inline; else the shm
    ring and the bulk conn where each is usable (a payload too large for
    the ring skips it without degrading it), then inline."""
    if cls == DEVICE and sock.dplane_eligible(nbytes):
        return [DEVICE]
    if cls == HOST:
        if nbytes < _flags.get_flag("ici_fabric_bulk_host_min"):
            return [INLINE]
    elif cls == STREAM:
        if nbytes < _flags.get_flag("ici_stream_bulk_threshold"):
            return [INLINE]
    out: List[str] = []
    if sock.plane_usable(SHM, nbytes):
        out.append(SHM)
    if sock.plane_usable(BULK, nbytes):
        out.append(BULK)
    out.append(INLINE)
    return out


_route_counters: Dict[str, tuple] = {}


def _counter_pair(label: str):
    pair = _route_counters.get(label)
    if pair is None:
        with _lock:
            pair = _route_counters.get(label)
            if pair is None:
                pair = _route_counters[label] = (
                    bvar.Adder(f"rpc_fabric_route_{label}_frames"),
                    bvar.Adder(f"rpc_fabric_route_{label}_bytes"))
    return pair


def record(sock, route: str, nbytes: int, frames: int = 1) -> None:
    """Count ``frames`` frame(s) of ``nbytes`` on ``route``; the bulk row
    is labelled by the transport of the socket's bulk conn."""
    if route == BULK:
        route = "uds" if getattr(sock, "_bulk_is_uds", False) else "tcp"
    pair = _counter_pair(route)
    pair[0] << frames
    pair[1] << nbytes


def record_shm_stripe(stripe: int, nbytes: int, frames: int = 1) -> None:
    """Count a striped ring's frame on its stripe
    (``rpc_fabric_route_shm_stripe_<i>_frames``/``_bytes``): the proof
    that a transfer was striped.  A 1-stripe ring counts on ``shm``
    only."""
    pair = _counter_pair(f"shm_stripe_{stripe}")
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
