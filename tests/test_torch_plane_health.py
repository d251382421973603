"""The plane-health timer latch and its counters in the port, held against
the JAX package's engine on the CPU.

The timer and slow cases of the JAX package's ``TestPlaneHealthChaosMatrix``
run as one event sequence on both engines — ``brpc_tpu.ici.plane_health``
and ``brpc_tpu_torch.ici.plane_health`` — side by side: after every step
the two ``snapshot()`` rows (without the ``reprobe_in`` countdown) and the
two ``plane_stats()`` deltas must be equal, and each must show what the
JAX test asserts.  The slow case delays each use (the JAX package's
fault-injection plan on its side, a plain sleep of the same length on the
port's, which ports no fault injection) and no policy may degrade.
"""
import threading
import time

import pytest

from brpc_tpu.ici import plane_health as jph
from brpc_tpu.ici import route as jroute
from brpc_tpu.rpc import fault_injection as jfi
from brpc_tpu_torch.ici import plane_health as tph
from brpc_tpu_torch.ici import route as troute

_EVENTS = ("down", "reprobe", "revived", "ramp")


def _delta(route, name, before):
    after = route.plane_stats()
    return {ev: after.get(f"{name}_{ev}", 0) - before.get(f"{name}_{ev}", 0)
            for ev in _EVENTS}


def _row(rec):
    snap = rec.snapshot()
    snap.pop("reprobe_in", None)
    return snap


class _Pair:
    """One record per engine under the same name and policy; ``do`` runs
    one step on both and holds the results, rows and deltas equal."""

    def __init__(self, name, **policy):
        self.name = name
        self.recs = {"jax": jph.register_plane(name, **policy),
                     "port": tph.register_plane(name, **policy)}
        self.before = {"jax": jroute.plane_stats(),
                       "port": troute.plane_stats()}

    def do(self, step):
        out = {k: step(rec) for k, rec in self.recs.items()}
        assert out["jax"] == out["port"]
        assert _row(self.recs["jax"]) == _row(self.recs["port"])
        assert self.delta("jax") == self.delta("port")
        return out["port"]

    def delta(self, side):
        route = jroute if side == "jax" else troute
        return _delta(route, self.name, self.before[side])


def test_timer_policy_blackhole_latch_lapses_then_relatches():
    """BLACK-HOLE × timer policy: the latch holds inside the window,
    re-degrading re-arms without a second down count, the lapse revives
    via the timer, the next verdict clears the ramp, and the next failure
    re-latches."""
    p = _Pair("tmx_timer", retry_s=lambda: 0.25)
    assert p.do(lambda r: r.mark_down("post timed out")) is True
    assert p.do(lambda r: r.usable()) is False          # inside the window
    assert all("reprobe_in" in r.snapshot() for r in p.recs.values())
    assert p.do(lambda r: r.mark_down("post timed out")) is False
    time.sleep(0.35)
    assert p.do(lambda r: r.usable()) is True           # lapse revives
    assert p.delta("port")["reprobe"] == 1              # via the timer
    assert p.do(lambda r: r.usable()) is True           # the ramp
    assert p.delta("port") == {"down": 1, "reprobe": 1, "revived": 1,
                               "ramp": 1}
    assert p.do(lambda r: r.mark_down("post timed out")) is True
    assert p.do(lambda r: r.usable()) is False
    assert p.delta("port")["down"] == 2
    row = _row(p.recs["port"])
    assert row["state"] == "down" and row["downs"] == 2 \
        and row["revivals"] == 1


def test_timer_policy_reported_revival_arms_the_ramp():
    """A plane that reports itself healthy before the latch lapses
    (``revived``) revives once, without a timer re-probe, and the next
    use clears the ramp."""
    p = _Pair("tmx_revived", retry_s=lambda: 30.0)
    assert p.do(lambda r: r.revived()) is False          # initial: no-op
    assert p.do(lambda r: r.mark_down("demote_io")) is True
    assert p.do(lambda r: r.usable()) is False
    assert p.do(lambda r: r.revived()) is True
    assert p.do(lambda r: _row(r)["reason"]) == ""
    assert p.do(lambda r: _row(r)["half_open"]) is True
    assert p.do(lambda r: r.usable()) is True
    assert p.delta("port") == {"down": 1, "reprobe": 0, "revived": 1,
                               "ramp": 1}


def test_slow_never_degrades_the_timer_policy():
    """SLOW × timer policy: latency is not death.  Each use runs late and
    no mark_down is issued, so the engine shows zero movement."""
    p = _Pair("tmx_slow_t", retry_s=lambda: 0.1)
    plan = jfi.FabricFaultPlan(plane_slow_ms={"tmx_slow_t": 10})
    with jfi.inject_fabric(plan):
        for _ in range(3):
            def step(rec):
                if rec is p.recs["jax"]:
                    plan.on_plane_op(None, "tmx_slow_t")
                else:
                    time.sleep(0.010)
                return rec.usable()
            assert p.do(step) is True
    assert plan.injected["plane_slow"] == 3
    row = _row(p.recs["port"])
    assert row["state"] == tph.UP and row["downs"] == 0
    assert p.delta("port") == dict.fromkeys(_EVENTS, 0)


def test_one_transition_one_count_under_racing_mark_downs():
    """Eight threads latch the same plane at once: exactly one wins the
    transition, on each engine."""
    p = _Pair("tmx_race", retry_s=lambda: 5.0)
    for side, rec in p.recs.items():
        wins = []
        start = threading.Barrier(8)

        def racer():
            start.wait()
            wins.append(rec.mark_down("peer_unreachable"))

        ts = [threading.Thread(target=racer) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(5)
        assert wins.count(True) == 1, side
    assert _row(p.recs["jax"]) == _row(p.recs["port"])
    assert p.delta("jax") == p.delta("port") == {
        "down": 1, "reprobe": 0, "revived": 0, "ramp": 0}


def test_register_plane_takes_the_planes_own_lock():
    lock = threading.Lock()
    rec = tph.register_plane("tmx_lock", lock, retry_s=lambda: 0.1)
    assert rec._lock is lock
    with pytest.raises(TypeError):
        tph.register_plane("tmx_bad")          # the timer latch needs retry_s


class _Epoch:
    """A membership epoch both engines read (the fan-out's registry)."""

    def __init__(self):
        self.value = 0

    def __call__(self):
        return self.value


def _hooked_pair(name, **policy):
    """A pair whose ``events`` hook logs into one list per engine: the
    hook must fire alike too."""
    logs = {"jax": [], "port": []}
    pair = _Pair.__new__(_Pair)
    pair.name = name
    pair.recs = {}
    for side, eng in (("jax", jph), ("port", tph)):
        log = logs[side]
        pair.recs[side] = eng.register_plane(
            name, events=lambda ev, why, log=log: log.append((ev, why)),
            **policy)
    pair.before = {"jax": jroute.plane_stats(),
                   "port": troute.plane_stats()}
    return pair, logs


def test_epoch_policy_membership_reason_waits_for_the_epoch():
    """The collective fan-out's policy: a membership reason stays down
    however long it waits, and revives when the epoch moves past the one
    recorded at the degrade — on both engines, events alike."""
    epoch = _Epoch()
    p, logs = _hooked_pair("tmx_epoch", epoch_fn=epoch,
                           transient_reasons=("exec_failed",),
                           reprobe_s=lambda: 0.01)
    epoch.value = 7
    assert p.do(lambda r: r.mark_down("member_killed")) is True
    assert p.do(lambda r: _row(r)["down_epoch"]) == 7
    assert p.do(lambda r: r.mark_down("member_killed")) is False
    time.sleep(0.05)                      # past reprobe_s: not transient
    assert p.do(lambda r: r.usable()) is False
    epoch.value = 8
    assert p.do(lambda r: r.usable()) is True
    assert p.do(lambda r: r.usable()) is True        # the ramp
    assert p.delta("port") == {"down": 1, "reprobe": 1, "revived": 1,
                               "ramp": 1}
    assert logs["port"] == logs["jax"] == [
        ("degraded", "member_killed"), ("revived", "member_killed")]


def test_epoch_policy_transient_reason_reprobes_on_its_timer():
    """A transient reason (one bad execution) comes back after
    ``reprobe_s`` with no epoch move; the row shows the countdown while
    it waits."""
    epoch = _Epoch()
    p, logs = _hooked_pair("tmx_epoch_t", epoch_fn=epoch,
                           transient_reasons=("exec_failed",),
                           reprobe_s=lambda: 0.2)
    assert p.do(lambda r: r.mark_down("exec_failed")) is True
    assert p.do(lambda r: r.usable()) is False
    assert all("reprobe_in" in r.snapshot() for r in p.recs.values())
    time.sleep(0.3)
    assert p.do(lambda r: r.usable()) is True
    assert p.delta("port") == {"down": 1, "reprobe": 1, "revived": 1,
                               "ramp": 0}
    assert logs["port"] == logs["jax"]
    assert logs["port"] == [("degraded", "exec_failed"),
                            ("revived", "exec_failed")]


def test_reported_revival_fires_the_revived_event():
    """``revived()`` on a down record fires ``revived`` with the reason it
    clears, on both engines."""
    p, logs = _hooked_pair("tmx_hs", retry_s=lambda: 30.0)
    assert p.do(lambda r: r.mark_down("demote_io")) is True
    assert p.do(lambda r: r.revived()) is True
    assert logs["port"] == logs["jax"]
    assert logs["port"] == [("degraded", "demote_io"),
                            ("revived", "demote_io")]
