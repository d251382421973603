"""The port's serving autoscaler and the elastic decode fleet under it,
held against the JAX package on the CPU.

  * Parity: seeded load series drive both packages'
    ``LoadThresholdAutoscaler`` through ``tick(now)``; every decision,
    counter and ``describe()`` must agree.  The router's membership
    (``add_target`` / ``remove_target``) and
    ``KvPoolOptions.from_admission`` are held against the JAX package's
    the same way.
  * The JAX package's ``TestAutoscaler`` cases and
    ``test_autoscaler_drain_runs_before_scale_down`` on both packages.
  * The in-process scale-down on the CPU stack (prefill ``ici://1``,
    decode ``ici://2`` and ``ici://3``, the router on ``mem://``, the
    device plane engaged): the drain moves every live session off rank 3
    with ``Decode.MigrateOut``, the scale-down deregisters rank 3 and
    stops it with a lame-duck drain, Generates carry on through it, the
    migrated sessions decode on rank 2 to the JAX reference's tokens, and
    a scale-up under load restarts rank 3, which the health checker's
    probe revives and the router routes to again.
"""
from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import serving as jserving
from brpc_tpu.rpc.admission import AdmissionOptions as JAdmissionOptions
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch import serving as tserving
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import health_check, lameduck
from brpc_tpu_torch.rpc.controller import server_controller_pool
from examples.disagg_serving import model as jmodel

PKGS = [pytest.param(jserving, id="jax"), pytest.param(tserving, id="port")]


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    yield
    deadline = time.monotonic() + 2.0
    plane = dp.DevicePlane._instance
    while (rpc.list_sockets() or server_controller_pool.live()
           or (plane is not None and plane.active_transfers())) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0
    assert plane is None or plane.active_transfers() == 0


def _mk(serving, loads, size0=1, drain=None, **kw):
    state = {"size": size0, "ups": 0, "downs": 0, "i": 0, "order": []}

    def load_fn():
        i = min(state["i"], len(loads) - 1)
        state["i"] += 1
        return loads[i]

    def up():
        state["size"] += 1
        state["ups"] += 1
        state["order"].append("up")
        return True

    def down():
        state["size"] -= 1
        state["downs"] += 1
        state["order"].append("down")
        return True

    a = serving.LoadThresholdAutoscaler(
        load_fn, lambda: state["size"], up, down,
        options=serving.AutoscalerOptions(**kw), drain=drain)
    return a, state


# ---- parity ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_autoscaler_parity_on_seeded_load_series(seed):
    rng = np.random.default_rng(400 + seed)
    # a random walk through the bands, with bursts
    loads = np.clip(np.cumsum(rng.normal(0, 0.2, 300)) % 1.4, 0, 1.2)
    kw = dict(high_water=0.7, low_water=0.3,
              samples_to_scale=int(rng.integers(1, 4)),
              cooldown_s=float(rng.choice([0.0, 2.0, 5.0])),
              min_size=1, max_size=int(rng.integers(2, 5)))
    got = []
    for serving in (jserving, tserving):
        drains = []
        a, st = _mk(serving, list(loads), size0=2,
                    drain=lambda d=drains: d.append(1), **kw)
        ticks = [a.tick(now=float(i)) for i in range(len(loads))]
        d = a.describe()
        got.append((ticks, st["size"], st["order"], len(drains), d))
    assert got[0] == got[1]
    ticks = got[1][0]
    assert "up" in ticks and "down" in ticks
    assert got[1][3] == got[1][4]["scale_downs"]     # a drain per down


def test_router_membership_agrees_with_the_jax_router():
    routers = [jserving.LoadAwareRouter(["ici://2", "ici://3"]),
               tserving.LoadAwareRouter(["ici://2", "ici://3"])]
    try:
        seen = []
        for r in routers:
            steps = [sorted(r.targets())]
            steps.append(r.remove_target("ici://3"))
            steps.append(r.remove_target("ici://3"))
            steps.append(sorted(r.targets()))
            steps.append({r.pick() for _ in range(16)})
            steps.append(r.add_target("ici://3"))
            steps.append(r.add_target("ici://3"))
            steps.append(sorted(r.targets()))
            seen.append(steps)
        assert seen[0] == seen[1]
    finally:
        for r in routers:
            r.close()


def test_pool_options_from_admission_agree():
    kw = dict(tenant_weights={"gold": 4, "free": 1},
              default_tenant_weight=2)
    jopts = jserving.KvPoolOptions.from_admission(
        JAdmissionOptions(**kw), bytes_per_token=64, num_blocks=8)
    topts = tserving.KvPoolOptions.from_admission(
        rpc.AdmissionOptions(**kw), bytes_per_token=64, num_blocks=8)
    for f in ("tenant_weights", "default_tenant_weight", "bytes_per_token",
              "num_blocks", "block_tokens", "host_blocks", "ttl_s",
              "bands", "default_priority"):
        assert getattr(jopts, f) == getattr(topts, f), f
    pool = tserving.PagedKvPool(topts, device="cpu")
    try:
        assert pool._weight("gold") == 4
        assert pool._weight("other") == 2
    finally:
        pool.close()


def _six_band_pool_run(serving, admission_options):
    """A pool from ``AdmissionOptions(bands=6, default_priority=3)``: its
    options, then the order in which pressure from three priority-0 loads
    evicts one-block sessions at priorities 0-5, 7 (clamped) and none
    (the default)."""
    opts = serving.KvPoolOptions.from_admission(
        admission_options(bands=6, default_priority=3),
        bytes_per_token=16, num_blocks=8, block_tokens=4, use_timers=False)
    kw = {} if serving is jserving else {"device": "cpu"}
    pool = serving.PagedKvPool(opts, **kw)
    def rows(k):     # distinct bytes: no two sessions share a block
        return np.full((4, 16), k, dtype=np.uint8)
    try:
        for k, pri in enumerate((0, 1, 2, 3, 4, 5, 7, None)):
            pool.load(f"p{pri}", rows(k), last_token=1, priority=pri)
        evicted = []
        for k in range(3):
            pool.load(f"new{k}", rows(10 + k), last_token=1, priority=0)
            evicted += sorted(s for s in ("p0", "p1", "p2", "p3", "p4",
                                          "p5", "p7", "pNone")
                              if s not in evicted and pool.get(s) is None)
        return ((opts.bands, opts.default_priority), evicted,
                [pool._clip_priority(p) for p in (None, -1, 4, 5, 9)])
    finally:
        pool.close()


@pytest.mark.parametrize("serving", PKGS)
def test_six_band_admission_options_serve_like_jax(serving):
    """Admission options with six bands give the pool six bands on both
    packages: equal options, an equal eviction order (the two band-5
    sessions before band 4, then band 3's), an equal clamp."""
    adm = JAdmissionOptions if serving is jserving else rpc.AdmissionOptions
    got = _six_band_pool_run(serving, adm)
    assert got == _six_band_pool_run(jserving, JAdmissionOptions)
    assert got[0] == (6, 3)
    assert got[1][:2] == ["p5", "p7"] and got[1][2] == "p4"
    assert got[2] == [3, 0, 4, 5, 5]


# ---- the JAX package's autoscaler cases, on both packages ---------------------

@pytest.mark.parametrize("serving", PKGS)
def test_hysteresis_and_cooldown(serving):
    a, st = _mk(serving, [0.9] * 5, samples_to_scale=2, cooldown_s=10.0,
                max_size=4)
    assert a.tick(now=0.0) is None
    assert a.tick(now=1.0) == "up"
    assert st["size"] == 2
    assert a.tick(now=2.0) is None
    assert a.tick(now=3.0) is None
    assert a.tick(now=12.0) == "up"
    assert a.tick(now=13.0) is None
    assert st["ups"] == 2


@pytest.mark.parametrize("serving", PKGS)
def test_scale_down_and_min_size(serving):
    a, st = _mk(serving, [0.1] * 6, size0=2, samples_to_scale=2,
                cooldown_s=0.0, min_size=1)
    assert a.tick(now=0.0) is None
    assert a.tick(now=1.0) == "down"
    assert st["size"] == 1
    assert a.tick(now=2.0) is None
    assert a.tick(now=3.0) is None
    assert st["size"] == 1


@pytest.mark.parametrize("serving", PKGS)
def test_max_size_and_mid_band_resets_runs(serving):
    a, st = _mk(serving, [0.9, 0.5, 0.9, 0.9], samples_to_scale=2,
                cooldown_s=0.0, max_size=2)
    assert a.tick(now=0.0) is None
    assert a.tick(now=1.0) is None
    assert a.tick(now=2.0) is None
    assert a.tick(now=3.0) == "up"
    assert st["size"] == 2
    d = a.describe()
    assert d["scale_ups"] == 1 and d["size"] == 2
    assert "load" in d["last"]


@pytest.mark.parametrize("serving", PKGS)
def test_autoscaler_drain_runs_before_scale_down(serving):
    order = []
    a = serving.LoadThresholdAutoscaler(
        load_fn=lambda: 0.0, size_fn=lambda: 2, scale_up=lambda: True,
        scale_down=lambda: order.append("down") or True,
        drain=lambda: order.append("drain"),
        options=serving.AutoscalerOptions(samples_to_scale=1,
                                          cooldown_s=0.0))
    assert a.tick(now=1.0) == "down"
    assert order == ["drain", "down"]
    order.clear()

    def bad_drain():
        order.append("drain")
        raise RuntimeError("migrate failed")
    a2 = serving.LoadThresholdAutoscaler(
        load_fn=lambda: 0.0, size_fn=lambda: 2, scale_up=lambda: True,
        scale_down=lambda: order.append("down") or True, drain=bad_drain,
        options=serving.AutoscalerOptions(samples_to_scale=1,
                                          cooldown_s=0.0))
    assert a2.tick(now=1.0) == "down"
    assert order == ["drain", "down"]
    assert a2.describe()["scale_downs"] == 1


@pytest.mark.parametrize("serving", PKGS)
def test_sampler_thread_starts_and_stops(serving):
    a, st = _mk(serving, [0.9] * 1000, samples_to_scale=2, cooldown_s=0.0,
                max_size=3, interval_s=0.01)
    a.start()
    deadline = time.monotonic() + 5
    while st["ups"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    a.stop()
    assert st["ups"] == 2 and st["size"] == 3
    assert not a.describe()["running"]


# ---- the in-process scale-down on the CPU stack ----------------------------

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold", "health_check_interval_s")
ROUTER = "mem://elastic-router"
MAX_BATCH = 4


def _svc(server):
    return next(iter(server.services().values()))


def _call(ch, method, body, cntl=None):
    cntl = cntl or rpc.Controller()
    resp = ch.call_method(method, cntl, EchoRequest(message=json.dumps(body)),
                          EchoResponse)
    return cntl, (json.loads(resp.message) if resp is not None else None)


def test_scale_down_by_migration_then_lame_duck_stop():
    from brpc_tpu_torch.examples.disagg_serving import model as tmodel
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        close_services, start_decode_worker, start_prefill_worker,
        start_router)
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 64 * 1024)
    tflags.set_flag("health_check_interval_s", 30.0)
    sched = tserving.BatchSchedulerOptions(vocab=tmodel.VOCAB,
                                           max_batch=MAX_BATCH)
    prefill = start_prefill_worker("ici://1")
    decodes = {url: start_decode_worker(url, sched_options=sched)
               for url in ("ici://2", "ici://3")}
    router = start_router(ROUTER, "ici://1", list(decodes),
                          rng=random.Random(5))
    rsvc = _svc(router)
    live = dict(decodes)               # the fleet as the router sees it
    front = rpc.Channel()
    front.init(ROUTER, options=rpc.ChannelOptions(
        timeout_ms=60000, max_retry=0))
    chans = {}

    def channel(url):
        if url not in chans:
            ch = rpc.Channel()
            ch.init(url, options=rpc.ChannelOptions(
                timeout_ms=60000, max_retry=0))
            chans[url] = ch
        return chans[url]

    rng = np.random.default_rng(23)

    def prompt(n):
        return rng.integers(0, jmodel.VOCAB, n).tolist()

    def generate(tokens, steps=8):
        cntl, out = _call(front, "Router.Generate",
                          {"tokens": tokens, "steps": steps})
        assert not cntl.failed(), cntl.error_text
        assert out["tokens"] == jmodel.reference_generate(tokens, steps)
        return out["decode_worker"]

    def load_fn():
        svcs = [_svc(s) for s in live.values()]
        return sum(s.load() for s in svcs) / len(svcs)

    stops = {}

    def drain():
        src = _svc(decodes["ici://3"])
        for session in src.pool.session_ids():
            cntl, out = _call(channel("ici://3"), "Decode.MigrateOut",
                              {"session": session, "dest": "ici://2"})
            assert not cntl.failed(), cntl.error_text

    def scale_down():
        server = live.pop("ici://3")
        rsvc.remove_decode_target("ici://3")
        t0 = time.monotonic()
        server.stop(grace_s=2.0)
        stops["down_s"] = time.monotonic() - t0
        stops["inflight"] = server.inflight_requests()
        stops["active"] = dp.plane().active_transfers()
        return True

    def scale_up():
        server = decodes["ici://3"]
        assert server.start("ici://3") == 0
        live["ici://3"] = server
        rsvc.add_decode_target("ici://3")
        return True

    step_gate = threading.Event()
    step_gate.set()
    scaler = tserving.LoadThresholdAutoscaler(
        load_fn, lambda: len(live), scale_up, scale_down, drain=drain,
        options=tserving.AutoscalerOptions(samples_to_scale=2,
                                           cooldown_s=2.0, min_size=1,
                                           max_size=2))
    try:
        # six live sessions on rank 3, loaded with LoadKv over the plane
        held = {f"h{i}": prompt(96 + 16 * i) for i in range(6)}
        for session, tokens in held.items():
            kv = mesh.own(tmodel.toy_kv_blocks(tokens, "cpu"), 1)
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(kv)
            cntl, _ = _call(channel("ici://3"), "Decode.LoadKv",
                            {"session": session, "seq_len": len(tokens),
                             "last_token": tokens[-1]}, cntl)
            assert not cntl.failed(), cntl.error_text
        workers = [generate(prompt(128)) for _ in range(3)]
        assert set(workers) <= {"ici://2", "ici://3"}
        # idle: two low samples scale down, the drain first
        received0 = _svc(decodes["ici://2"]).migrate_in_received
        transfers0 = dp.plane().stats()["transfers"]
        assert scaler.tick(now=0.0) is None
        assert scaler.tick(now=1.0) == "down"
        assert _svc(decodes["ici://2"]).migrate_in_received - received0 \
            == len(held)
        assert dp.plane().stats()["transfers"] - transfers0 == len(held)
        assert _svc(decodes["ici://3"]).pool.session_ids() == []
        assert stops["inflight"] == 0 and stops["active"] == 0
        assert not decodes["ici://3"].is_running()
        assert rsvc.describe_serving()["router"]["weights"].keys() == \
            {"ici://2"}
        # traffic carries on through the shrunk fleet
        assert {generate(prompt(100)) for _ in range(3)} == {"ici://2"}
        # load: the migrated sessions decode on rank 2, async, 64 steps.
        # A 64-step decode takes milliseconds here, so sessions sent one
        # by one may finish before the last arrives: the step is held
        # until all six are queued, the scaler samples, then it runs
        results = {}
        done_all = threading.Event()

        def on_done(session, c):
            results[session] = (c.error_code_, None if c.failed() else
                                json.loads(c.response.message)["tokens"])
            if len(results) == len(held):
                done_all.set()
        sched2 = _svc(decodes["ici://2"]).scheduler
        step_gate.clear()
        real_step = sched2.step_once

        def held_step():
            step_gate.wait(60)
            return real_step()
        sched2.step_once = held_step
        for session in held:
            cntl = rpc.Controller()
            channel("ici://2").call_method(
                "Decode.Decode", cntl, EchoRequest(message=json.dumps(
                    {"session": session, "steps": 64})), EchoResponse,
                done=lambda c, s=session: on_done(s, c))
        deadline = time.monotonic() + 10
        while True:
            d = sched2.describe()
            if d["active"] + sum(d["pending_by_band"]) == len(held):
                break
            assert time.monotonic() < deadline, (
                "the six decodes were not all queued within 10 s", d,
                results)
            time.sleep(0.001)
        assert load_fn() >= 0.75, (sched2.describe(), results)
        assert scaler.tick(now=3.0) is None
        assert scaler.tick(now=3.5) == "up"
        step_gate.set()
        del sched2.step_once
        assert done_all.wait(60)
        for session, tokens in held.items():
            assert results[session] == (
                0, jmodel.reference_generate(tokens, 64)), session
        # rank 3 is back.  Its GOODBYE reached whichever connections
        # were open at the stop (the router closed its own channel first,
        # and with it the process's shared connection); the checker's
        # probe, run here directly, lifts any peer mark
        ep3 = parse_endpoint("ici://3")
        assert health_check.start_health_check(ep3).probe_now()
        assert not lameduck.is_draining(ep3)
        seen = set()
        for _ in range(8):
            seen.add(generate(prompt(80)))
            if "ici://3" in seen:
                break
        assert "ici://3" in seen, seen
        d = scaler.describe()
        assert (d["scale_downs"], d["scale_ups"]) == (1, 1)
        serving = rsvc.describe_serving()["router"]
        assert serving["generate_failures"] == 0
    finally:
        step_gate.set()
        scaler.stop()
        for ch in chans.values():
            ch.close()
        front.close()
        close_services(router, prefill, *decodes.values())
        t = health_check._tasks.get(parse_endpoint("ici://3"))
        if t is not None:
            t.cancel()
        lameduck.clear_peer_draining(parse_endpoint("ici://3"))
        for n, v in saved.items():
            tflags.set_flag(n, v)
        IciMesh.set_default(None)
