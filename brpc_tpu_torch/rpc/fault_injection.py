"""Fault injection: the Socket.write injector and the fabric fault plan.

Port of :mod:`brpc_tpu.rpc.fault_injection`, in two parts.

The socket injector acts at the ``Socket.write`` boundary, the place a
lossy or partitioned link would: a :class:`FaultInjector` installed with
:func:`install` (or scoped with :class:`inject`) decides each write,
``PASS`` (after an optional delay), ``DROP`` (the bytes vanish) or
``ERROR`` (the connection is severed).  The decision comes ahead of the
write queue, so a dropped frame never reaches the transport: on ``ici://``
its DEVICE blocks post no transfer on the device plane.  Deterministic
given a seed, thread-safe, and gone once uninstalled::

    with fault_injection.inject(FaultInjector(drop_ratio=0.3, seed=7)):
        ...   # three writes in ten silently vanish

The fabric half: a :class:`FabricFaultPlan` installed with
:func:`install_fabric` (or scoped with :class:`inject_fabric`) is consulted
by the multi-process fabric (:mod:`..ici.fabric`), the device plane and the
compiled collective fan-out at the JAX package's points, with the JAX
package's knobs for the planes the port has: the control channel, the
handshake, the device plane's posts and the collective fan-out.  The bulk
plane, the shm ring and the transfer server are not ported, and their
knobs (and ``chaos_plane``, which acts on the first two) with them: the
constructor refuses them, naming the tier they wait for.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

PASS = "pass"
DROP = "drop"          # the bytes vanish (a lossy link, a partition)
ERROR = "error"        # the connection is severed (a peer reset)


class FaultInjector:
    """Decides every ``Socket.write`` that ``match`` accepts (default:
    every one): a seeded draw below ``drop_ratio`` drops, below
    ``drop_ratio + error_ratio`` severs, and otherwise the write passes,
    after ``delay_ms`` when set.  ``injected`` counts each outcome."""

    def __init__(self, drop_ratio: float = 0.0, error_ratio: float = 0.0,
                 delay_ms: float = 0.0, seed: int = 0,
                 match: Optional[Callable] = None):
        self.drop_ratio = drop_ratio
        self.error_ratio = error_ratio
        self.delay_ms = delay_ms
        self.match = match
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected = {DROP: 0, ERROR: 0, "delayed": 0}

    def decide(self, socket) -> str:
        if self.match is not None and not self.match(socket):
            return PASS
        with self._lock:
            r = self._rng.random()
            if r < self.drop_ratio:
                self.injected[DROP] += 1
                return DROP
            if r < self.drop_ratio + self.error_ratio:
                self.injected[ERROR] += 1
                return ERROR
            if self.delay_ms > 0:
                self.injected["delayed"] += 1
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1000.0)
        return PASS


_active: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
    global _active
    _active = injector


def active() -> Optional[FaultInjector]:
    return _active


class inject:
    """Context manager: install an injector for the with-block and restore
    the previous one after."""

    def __init__(self, injector: FaultInjector):
        self.injector = injector
        self._prev: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        self._prev = _active
        install(self.injector)
        return self.injector

    def __exit__(self, *exc) -> None:
        install(self._prev)


# the JAX plan's knobs for tiers the port does not have yet
_LATER_TIERS = {
    "bulk_sever_now": "bulk plane", "bulk_sever_after_bytes": "bulk plane",
    "bulk_drop_frames": "bulk plane", "bulk_delay_park_ms": "bulk plane",
    "refuse_bulk_handshakes": "bulk plane", "shm_kill_now": "shm ring",
    "shm_sever_after_bytes": "shm ring", "shm_drop_frames": "shm ring",
    "refuse_shm_handshakes": "shm ring",
    "xfer_refuse_stages": "transfer server",
}
# the planes plane_slow_ms may slow here
SLOW_PLANES = ("device", "collective")


class FabricFaultPlan:
    """A deterministic fault plan for ici:// fabric sockets.

    Every knob is a count or a watermark (exact) or a ratio drawn from a
    generator seeded with ``seed`` (reproducible: the JAX plan's draws on
    the same seed), and the socket-scoped knobs apply only to sockets that
    ``match`` accepts (default: every fabric socket).  Consulted at the
    JAX package's points:

      control_sever_after_frames  sever the control TCP after this many
                                  outbound control frames (0 = off);
                                  ``FabricSocket._ctrl_send``
      control_drop_ratio          seeded per-frame drop of outbound
                                  control frames (a lossy control link)
      die_after_control_frames    ``os._exit(137)`` after this many
                                  INBOUND control frames, the "peer
                                  process killed" fault, installed in the
                                  victim; the socket's read loop
      refuse_hellos               the server refuses the next N control
                                  HELLOs with HELLO_ERR; the handshake
      device_plane_fail_posts     refuse the next N device-plane
                                  ``post_send`` WRs before any descriptor
                                  exists.  The JAX plane then sends the
                                  payload on the bulk plane or inline;
                                  the port has no such tier, so the write
                                  fails with EINTERNAL and the reason and
                                  the peer's device plane latches down
      collective_kill_device      refuse every compiled fan-out whose
                                  members include this device, the
                                  "member killed mid-fan-out" fault: the
                                  call degrades in-call to per-member
                                  RPCs, and the route revives only when
                                  the epoch moves (the plan cleared and
                                  the member re-advertised)
      collective_fail_execs       refuse the next N compiled fan-outs
                                  whatever their members (a transient
                                  execution failure)
      collective_drop_announces   swallow the next N cross-process fan-out
                                  announces: the member never sees the
                                  call, the client times out and degrades
                                  in-call (``announce_refused``)
      plane_slow_ms               {plane: ms}: one sleep per operation on
                                  the "device" plane (a cross-process
                                  pull, at its slot) or the "collective"
                                  plane (a fan-out announce), "slow, not
                                  dead": a correct health machine does
                                  not degrade it

    ``injected`` counts what fired, under the JAX plan's keys."""

    def __init__(self, seed: int = 0,
                 match: Optional[Callable] = None,
                 control_sever_after_frames: int = 0,
                 control_drop_ratio: float = 0.0,
                 die_after_control_frames: int = 0,
                 refuse_hellos: int = 0,
                 device_plane_fail_posts: int = 0,
                 collective_kill_device: Optional[int] = None,
                 collective_fail_execs: int = 0,
                 collective_drop_announces: int = 0,
                 plane_slow_ms: Optional[dict] = None,
                 **later_tiers):
        for knob in later_tiers:
            tier = _LATER_TIERS.get(knob)
            if tier is None:
                raise TypeError(f"FabricFaultPlan: unknown knob {knob!r}")
            raise ValueError(f"FabricFaultPlan: {knob} acts on the {tier}, "
                             f"which the port does not have yet")
        for plane in plane_slow_ms or {}:
            if plane not in SLOW_PLANES:
                raise ValueError(
                    f"FabricFaultPlan: plane_slow_ms[{plane!r}]: the port "
                    f"slows only the {' and '.join(SLOW_PLANES)} planes")
        self.match = match
        self.control_sever_after_frames = control_sever_after_frames
        self.control_drop_ratio = control_drop_ratio
        self.die_after_control_frames = die_after_control_frames
        self._refuse_hellos = refuse_hellos
        self._fail_device_posts = device_plane_fail_posts
        self.collective_kill_device = collective_kill_device
        self._fail_coll_execs = collective_fail_execs
        self._drop_announces = collective_drop_announces
        self.plane_slow_ms = dict(plane_slow_ms or {})
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ctrl_out = 0           # outbound control frames seen
        self._ctrl_in = 0            # inbound control frames seen
        self.injected = {"control_sever": 0, "control_drop": 0,
                         "refuse_hello": 0, "die": 0, "device_plane": 0,
                         "collective": 0, "coll_announce_drop": 0,
                         "plane_slow": 0}

    def _matches(self, socket) -> bool:
        return self.match is None or bool(self.match(socket))

    # -- control channel -------------------------------------------------
    def on_control_send(self, socket) -> str:
        """PASS / DROP / ERROR for one outbound control frame."""
        if not self._matches(socket):
            return PASS
        with self._lock:
            self._ctrl_out += 1
            if (self.control_sever_after_frames
                    and self._ctrl_out >= self.control_sever_after_frames):
                self.control_sever_after_frames = 0   # fires once
                self.injected["control_sever"] += 1
                return ERROR
            if (self.control_drop_ratio
                    and self._rng.random() < self.control_drop_ratio):
                self.injected["control_drop"] += 1
                return DROP
        return PASS

    def on_control_recv(self, socket) -> None:
        """Counts inbound control frames; kills the process at the
        configured count (the deterministic "peer crash" fault)."""
        if not self.die_after_control_frames or not self._matches(socket):
            return
        with self._lock:
            self._ctrl_in += 1
            if self._ctrl_in < self.die_after_control_frames:
                return
            self.injected["die"] += 1
        import os
        os._exit(137)

    # -- handshake and device plane --------------------------------------
    def on_hello(self) -> bool:
        """True: the server refuses this control HELLO."""
        with self._lock:
            if self._refuse_hellos > 0:
                self._refuse_hellos -= 1
                self.injected["refuse_hello"] += 1
                return True
        return False

    def on_device_post(self, socket=None) -> bool:
        """True: refuse this device-plane post (the WR fails before any
        descriptor exists)."""
        if socket is not None and not self._matches(socket):
            return False
        with self._lock:
            if self._fail_device_posts > 0:
                self._fail_device_posts -= 1
                self.injected["device_plane"] += 1
                return True
        return False

    def on_plane_op(self, socket, plane: str) -> None:
        """The SLOW injector: delay one operation on ``plane`` by
        ``plane_slow_ms[plane]``."""
        ms = self.plane_slow_ms.get(plane, 0)
        if not ms or (socket is not None and not self._matches(socket)):
            return
        with self._lock:
            self.injected["plane_slow"] += 1
        time.sleep(ms / 1000.0)

    # -- the collective fan-out ------------------------------------------
    def on_collective_execute(self, devices=()) -> Optional[str]:
        """The refusal's reason (the fan-out degrades in-call to
        per-member RPCs), or None.  Consulted between the screen and the
        entry, the window where a member that dies after the client
        committed to the compiled route would be found."""
        with self._lock:
            if self.collective_kill_device is not None \
                    and self.collective_kill_device in devices:
                self.injected["collective"] += 1
                return (f"member ici://{self.collective_kill_device} "
                        f"killed mid-fan-out")
            if self._fail_coll_execs > 0:
                self._fail_coll_execs -= 1
                self.injected["collective"] += 1
                return "injected collective execution failure"
        return None

    def on_collective_announce(self) -> bool:
        """True: swallow this fan-out announce (a black hole)."""
        with self._lock:
            if self._drop_announces > 0:
                self._drop_announces -= 1
                self.injected["coll_announce_drop"] += 1
                return True
        return False


_fabric_active: Optional[FabricFaultPlan] = None


def install_fabric(plan: Optional[FabricFaultPlan]) -> None:
    global _fabric_active
    _fabric_active = plan


def fabric_active() -> Optional[FabricFaultPlan]:
    return _fabric_active


class inject_fabric:
    """Context manager: install a plan for the with-block and restore the
    previous one after."""

    def __init__(self, plan: FabricFaultPlan):
        self.plan = plan
        self._prev: Optional[FabricFaultPlan] = None

    def __enter__(self) -> FabricFaultPlan:
        self._prev = _fabric_active
        install_fabric(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        install_fabric(self._prev)
