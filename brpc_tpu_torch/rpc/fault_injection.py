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
compiled collective fan-out, with the JAX package's knobs for every plane
the port has: the control channel, the handshake, the device plane's
posts, the bulk conn, the shm ring and the collective fan-out.  Each knob
acts at the JAX package's point.  Of the ``plane_slow_ms`` planes,
"device" (a pull at its slot) and "shm" (a ring send) are the JAX
package's points; "bulk" is taken, as the JAX plan takes it, and slows
nothing (the JAX package has no such point: a slow bulk conn is
:func:`chaos_plane`'s ``SLOW``); "collective", one sleep per member at the
fan-out's announce, is the port's own point.  The transfer server is not
ported, and its knob ``xfer_refuse_stages`` with it: the constructor
refuses it.
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
_LATER_TIERS = {"xfer_refuse_stages": "transfer server"}
# the planes plane_slow_ms takes here ("bulk" slows nothing, as in the
# JAX package)
SLOW_PLANES = ("device", "shm", "bulk", "collective")

# the native chaos modes (csrc/fabric_native.cpp's fab_chaos; the ring's
# shm_chaos shares the numbering, the delay excepted)
CHAOS_CLEAR = 0
CHAOS_SEVER_AFTER_OUT_BYTES = 1
CHAOS_DROP_FRAMES = 2
CHAOS_DELAY_PARK_MS = 3
CHAOS_SEVER_NOW = 4


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
      bulk_sever_now              sever the bulk conn the moment it is
                                  (re)attached: the plane's death with a
                                  live control channel
      bulk_sever_after_bytes      native watermark: the write that crosses
                                  it is cut mid-writev
      bulk_drop_frames            native: the next N received bulk frames
                                  vanish before parking (the descriptor
                                  arrives, the claim is never met)
      bulk_delay_park_ms          native: park received bulk frames only
                                  after this many ms (descriptor/claim
                                  skew)
      refuse_bulk_handshakes      refuse the next N bulk (re)establishment
                                  handshakes
      refuse_hellos               the server refuses the next N control
                                  HELLOs with HELLO_ERR; the handshake
      device_plane_fail_posts     refuse the next N device-plane
                                  ``post_send`` WRs before any descriptor
                                  exists.  The JAX plane then sends the
                                  payload on the bulk plane or inline;
                                  the port has no such tier, so the write
                                  fails with EINTERNAL and the reason and
                                  the peer's device plane latches down
      shm_kill_now                mark the ring dead the moment it is
                                  (re)attached, the "segment killed"
                                  fault: frames fall to the bulk conn
      shm_sever_after_bytes       native watermark: the ring write that
                                  crosses it copies a partial slot and
                                  dies without publishing
      shm_drop_frames             native: the next N ring frames vanish at
                                  the receiver's scan
      refuse_shm_handshakes       refuse the next N ring attaches (at the
                                  HELLO or a revival)
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
      plane_slow_ms               {plane: ms}: one sleep per operation,
                                  "slow, not dead" (a correct health
                                  machine does not degrade it), on the
                                  "device" plane (a cross-process pull, at
                                  its slot) and the "shm" plane (a ring
                                  send), the JAX package's points; "bulk"
                                  is taken and slows nothing, as in the
                                  JAX package; "collective" (a fan-out
                                  announce) is the port's own point

    ``injected`` counts what fired, under the JAX plan's keys."""

    def __init__(self, seed: int = 0,
                 match: Optional[Callable] = None,
                 control_sever_after_frames: int = 0,
                 control_drop_ratio: float = 0.0,
                 die_after_control_frames: int = 0,
                 bulk_sever_now: bool = False,
                 bulk_sever_after_bytes: int = 0,
                 bulk_drop_frames: int = 0,
                 bulk_delay_park_ms: int = 0,
                 refuse_bulk_handshakes: int = 0,
                 refuse_hellos: int = 0,
                 device_plane_fail_posts: int = 0,
                 shm_kill_now: bool = False,
                 shm_sever_after_bytes: int = 0,
                 shm_drop_frames: int = 0,
                 refuse_shm_handshakes: int = 0,
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
                    f"takes only the {', '.join(SLOW_PLANES)} planes")
        self.match = match
        self.control_sever_after_frames = control_sever_after_frames
        self.control_drop_ratio = control_drop_ratio
        self.die_after_control_frames = die_after_control_frames
        self.bulk_sever_now = bulk_sever_now
        self.bulk_sever_after_bytes = bulk_sever_after_bytes
        self.bulk_drop_frames = bulk_drop_frames
        self.bulk_delay_park_ms = bulk_delay_park_ms
        self._refuse_bulk = refuse_bulk_handshakes
        self._refuse_hellos = refuse_hellos
        self._fail_device_posts = device_plane_fail_posts
        self.shm_kill_now = shm_kill_now
        self.shm_sever_after_bytes = shm_sever_after_bytes
        self.shm_drop_frames = shm_drop_frames
        self._refuse_shm = refuse_shm_handshakes
        self.collective_kill_device = collective_kill_device
        self._fail_coll_execs = collective_fail_execs
        self._drop_announces = collective_drop_announces
        self.plane_slow_ms = dict(plane_slow_ms or {})
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ctrl_out = 0           # outbound control frames seen
        self._ctrl_in = 0            # inbound control frames seen
        self.injected = {"control_sever": 0, "control_drop": 0,
                         "bulk_chaos": 0, "refuse_bulk": 0,
                         "refuse_hello": 0, "die": 0, "device_plane": 0,
                         "shm_chaos": 0, "refuse_shm": 0, "collective": 0,
                         "coll_announce_drop": 0, "xfer": 0,
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

    # -- the bulk conn and the shm ring ----------------------------------
    def on_bulk_attach(self, socket, lib, handle: int) -> None:
        """Arm the native knobs on a just-attached bulk conn."""
        if not handle or lib is None or not self._matches(socket):
            return
        fired = False
        for on, mode, arg in (
                (self.bulk_sever_after_bytes, CHAOS_SEVER_AFTER_OUT_BYTES,
                 self.bulk_sever_after_bytes),
                (self.bulk_drop_frames, CHAOS_DROP_FRAMES,
                 self.bulk_drop_frames),
                (self.bulk_delay_park_ms, CHAOS_DELAY_PARK_MS,
                 self.bulk_delay_park_ms),
                (self.bulk_sever_now, CHAOS_SEVER_NOW, 0)):
            if on:
                lib.brpc_tpu_torch_fab_chaos(handle, mode, arg)
                fired = True
        if fired:
            with self._lock:
                self.injected["bulk_chaos"] += 1

    def on_shm_attach(self, socket, lib, handle: int) -> None:
        """Arm the native knobs on a just-attached ring."""
        if not handle or lib is None or not self._matches(socket):
            return
        fired = False
        for on, mode, arg in (
                (self.shm_sever_after_bytes, CHAOS_SEVER_AFTER_OUT_BYTES,
                 self.shm_sever_after_bytes),
                (self.shm_drop_frames, CHAOS_DROP_FRAMES,
                 self.shm_drop_frames),
                (self.shm_kill_now, CHAOS_SEVER_NOW, 0)):
            if on:
                lib.brpc_tpu_torch_shm_chaos(handle, mode, arg)
                fired = True
        if fired:
            with self._lock:
                self.injected["shm_chaos"] += 1

    def on_shm_handshake(self, socket=None) -> bool:
        """True: refuse this ring attach (at the HELLO or a revival)."""
        if socket is not None and not self._matches(socket):
            return False
        with self._lock:
            if self._refuse_shm > 0:
                self._refuse_shm -= 1
                self.injected["refuse_shm"] += 1
                return True
        return False

    def on_bulk_handshake(self, socket=None) -> bool:
        """True: refuse this bulk (re)establishment."""
        if socket is not None and not self._matches(socket):
            return False
        with self._lock:
            if self._refuse_bulk > 0:
                self._refuse_bulk -= 1
                self.injected["refuse_bulk"] += 1
                return True
        return False

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


# ---- plane-scoped chaos verbs ------------------------------------------

KILL = "kill"            # the plane dies now (sever / mark dead)
BLACKHOLE = "blackhole"  # received frames vanish silently
SLOW = "slow"            # ops delayed, not dead: must not degrade


def chaos_plane(sock, plane: str, mode: str, value: int = 0) -> bool:
    """Apply one failure mode to a live plane of one fabric socket, mid-
    traffic, through the native chaos entry on its current handle; True
    when armed.  Only "bulk" and "shm" are such planes, and the ring has
    no native delay (slow it with ``plane_slow_ms`` instead)."""
    if plane not in ("bulk", "shm"):
        return False
    with sock._bulk_lock:
        h = sock._bulk if plane == "bulk" else sock._shm
        lib = sock._blib if plane == "bulk" else sock._shmlib
    if not h or lib is None:
        return False
    fn = (lib.brpc_tpu_torch_fab_chaos if plane == "bulk"
          else lib.brpc_tpu_torch_shm_chaos)
    if mode == KILL:
        fn(h, CHAOS_SEVER_NOW, 0)
    elif mode == BLACKHOLE:
        fn(h, CHAOS_DROP_FRAMES, value or 1_000_000)
    elif mode == SLOW:
        if plane == "shm":
            return False
        fn(h, CHAOS_DELAY_PARK_MS, value or 20)
    else:
        return False
    return True


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
