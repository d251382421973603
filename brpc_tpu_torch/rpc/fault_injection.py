"""Fault injection: the Socket.write injector and the collective knobs.

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

The collective half: a :class:`FabricFaultPlan` installed with
:func:`install_fabric` (or scoped with :class:`inject_fabric`) is
consulted by the compiled collective fan-out between its screen and its
entry — the window where a member that dies after the client committed to
the compiled route would be found:

    collective_kill_device   refuse every compiled fan-out whose members
                             include this device — the "member killed
                             mid-fan-out" fault: the call degrades in-call
                             to per-member RPCs, and the route revives
                             only when the epoch moves (the plan cleared
                             and the member re-advertised)
    collective_fail_execs    refuse the next N compiled fan-outs whatever
                             their members (a transient execution failure)

``injected["collective"]`` counts what fired.  Every knob is a count, so a
plan injects the same faults on every run.  The JAX plan's control,
bulk, shm, announce, xfer and device-post knobs act on the fabric's
cross-process planes, which wait for the multi-process fabric.
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


class FabricFaultPlan:
    """A deterministic fault plan for the compiled collective fan-out."""

    def __init__(self, collective_kill_device: Optional[int] = None,
                 collective_fail_execs: int = 0):
        self.collective_kill_device = collective_kill_device
        self._fail_coll_execs = collective_fail_execs
        self._lock = threading.Lock()
        self.injected = {"collective": 0}

    def on_collective_execute(self, devices=()) -> Optional[str]:
        """The refusal's reason (the fan-out degrades in-call to
        per-member RPCs), or None."""
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
