"""Fault injection for the ici:// fabric, trimmed to the collective knobs.

Port of the collective half of :mod:`brpc_tpu.rpc.fault_injection`: a
:class:`FabricFaultPlan` installed with :func:`install_fabric` (or scoped
with :class:`inject_fabric`) is consulted by the compiled collective
fan-out between its screen and its entry — the window where a member that
dies after the client committed to the compiled route would be found:

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
cross-process planes, which wait for the multi-process fabric; the
Socket.write-level ``FaultInjector`` waits with them.
"""
from __future__ import annotations

import threading
from typing import Optional


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
