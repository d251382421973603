"""Load-threshold autoscaler: an elastic decode fleet under traffic.

Port of :mod:`brpc_tpu.serving.autoscaler` (the serving subsystem's
capacity loop).  A sampler thread reads one scalar load signal (typically
the decode schedulers' roster + queue pressure), and after
``samples_to_scale`` CONSECUTIVE samples beyond a watermark — with a
cooldown between actions, so one burst never see-saws the fleet — fires
the operator-supplied ``scale_up`` / ``scale_down`` callback.  The
callbacks do the actual work (start a decode worker and register it with
the router; for a scale-down, deregister one and stop it with a
lame-duck drain), so the policy here stays mechanism-free.  ``drain``
runs before every scale-down: the operator moves the doomed worker's
live sessions away first.

Attached to a :class:`~brpc_tpu_torch.ici.pod.Pod` (``pod=``), the
autoscaler also publishes each sampled load into the local member record
(``Pod.publish_load``: no epoch bump, load is telemetry, not membership)
and appears in the pod's ``/ici`` block.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..butil import debug_sync as _dbg
from .. import bvar
from ..butil import logging as log


@dataclass
class AutoscalerOptions:
    high_water: float = 0.75         # load above this long enough → up
    low_water: float = 0.25          # load below this long enough → down
    interval_s: float = 0.5          # sample period
    samples_to_scale: int = 2        # consecutive samples past a mark
    cooldown_s: float = 2.0          # min gap between actions
    min_size: int = 1
    max_size: int = 4


class LoadThresholdAutoscaler:
    """Sample → hysteresis → scale callback.  One per serving pod
    member (usually the one hosting the router)."""

    _GUARDED_BY = {
        "_hi_run": "_lock",
        "_lo_run": "_lock",
        "_last_action_ts": "_lock",
        "_last": "_lock",
        "_running": "_lock",
    }

    def __init__(self, load_fn: Callable[[], float],
                 size_fn: Callable[[], int],
                 scale_up: Callable[[], bool],
                 scale_down: Callable[[], bool],
                 options: Optional[AutoscalerOptions] = None,
                 pod=None,
                 drain: Optional[Callable[[], None]] = None):
        """``drain``: invoked before every ``scale_down``
        so the operator rebalances the doomed worker's live sessions
        first — migrate them to a surviving worker (or spill them to
        the host tier) instead of letting the kill turn them into
        re-prefills.  A raising drain is logged and the scale-down
        still proceeds (capacity policy outranks a failing drain)."""
        self.options = options or AutoscalerOptions()
        self._load_fn = load_fn
        self._size_fn = size_fn
        self._scale_up = scale_up
        self._scale_down = scale_down
        self._drain = drain
        self._pod = pod
        self._lock = _dbg.make_lock("LoadThresholdAutoscaler._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._hi_run = 0
        self._lo_run = 0
        # "never acted": the cooldown must not gate the FIRST action
        self._last_action_ts = float("-inf")
        self._last: dict = {"load": -1.0, "action": "", "reason": ""}
        self.samples = bvar.Adder("serving_autoscaler_samples")
        self.scale_ups = bvar.Adder("serving_autoscaler_scale_ups")
        self.scale_downs = bvar.Adder("serving_autoscaler_scale_downs")
        if pod is not None:
            pod.attach_autoscaler(self)

    # ---- lifecycle ------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
            self._stop.clear()
            t = threading.Thread(target=self._loop,
                                 name="serving_autoscaler", daemon=True)
            self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
            self._running = False
        if t is not None and t is not threading.current_thread():
            t.join(2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.options.interval_s):
            try:
                self.tick()
            except Exception:
                log.error("autoscaler tick failed", exc_info=True)

    # ---- the decision ---------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One sample + decision.  Public so tests (and simulated-clock
        harnesses) can drive it without the thread.  Returns "up" /
        "down" when an action fired, else None."""
        o = self.options
        now = time.monotonic() if now is None else now
        load = float(self._load_fn())
        size = int(self._size_fn())
        self.samples << 1
        if self._pod is not None:
            try:
                self._pod.publish_load(load)
            except Exception:
                pass
        action = None
        fire = None
        with self._lock:
            self._last["load"] = round(load, 3)
            if load >= o.high_water:
                self._hi_run += 1
                self._lo_run = 0
            elif load <= o.low_water:
                self._lo_run += 1
                self._hi_run = 0
            else:
                self._hi_run = self._lo_run = 0
            cool = now - self._last_action_ts >= o.cooldown_s
            if (self._hi_run >= o.samples_to_scale and cool
                    and size < o.max_size):
                action, fire = "up", self._scale_up
                reason = (f"load {load:.2f} >= {o.high_water} for "
                          f"{self._hi_run} samples")
            elif (self._lo_run >= o.samples_to_scale and cool
                    and size > o.min_size):
                action, fire = "down", self._scale_down
                reason = (f"load {load:.2f} <= {o.low_water} for "
                          f"{self._lo_run} samples")
            if action is not None:
                self._last_action_ts = now
                self._hi_run = self._lo_run = 0
                self._last["action"] = action
                self._last["reason"] = reason
        if fire is None:
            return None
        if action == "down" and self._drain is not None:
            try:
                self._drain()
            except Exception:
                log.error("autoscaler drain before scale_down failed",
                          exc_info=True)
        ok = False
        try:
            ok = bool(fire())
        except Exception:
            log.error("autoscaler scale_%s failed", action, exc_info=True)
        if ok:
            (self.scale_ups if action == "up" else self.scale_downs) << 1
        return action if ok else None

    # ---- observability --------------------------------------------------
    def describe(self) -> dict:
        o = self.options
        with self._lock:
            last = dict(self._last)
            running = self._running
        return {
            "running": running,
            "high_water": o.high_water,
            "low_water": o.low_water,
            "interval_s": o.interval_s,
            "size": self._size_fn(),
            "min_size": o.min_size,
            "max_size": o.max_size,
            "samples": self.samples.get_value(),
            "scale_ups": self.scale_ups.get_value(),
            "scale_downs": self.scale_downs.get_value(),
            "last": last,
        }
