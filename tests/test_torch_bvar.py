"""The port's bvar package held against the JAX package's on the CPU.

Runs ``tests/test_bvar.py``'s scenarios on both packages and compares
values and ``dump_exposed`` renderings.  Windows are driven by the
sampler's own tick (``SamplerCollector.instance().sample_once()``), never
by sleeping; percentile reservoirs draw from ``fast_rand``, seeded alike in
both packages, so their answers are equal too.
"""
from __future__ import annotations

import threading
import types

import pytest

from brpc_tpu import bvar as jbvar
from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil import misc as jmisc
from brpc_tpu_torch import bvar as tbvar
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil import misc as tmisc

JAX = types.SimpleNamespace(name="jax", bvar=jbvar, flags=jflags)
PORT = types.SimpleNamespace(name="torch", bvar=tbvar, flags=tflags)
BOTH = (JAX, PORT)


def _seed(seed: int) -> None:
    """Seed this thread's fast_rand in both packages."""
    jmisc._tls.s = [seed]
    tmisc.seed_fast_rand(seed)


def _both(fn):
    """fn(pkg) on each package; the two results."""
    return fn(JAX), fn(PORT)


def _tick(pkg) -> None:
    pkg.bvar.SamplerCollector.instance().sample_once()


# ---------------------------------------------------------------------------
# Reducers.
# ---------------------------------------------------------------------------

def test_adder_basic_alike():
    def run(pkg):
        a = pkg.bvar.Adder()
        a << 5
        a << 3
        seen = [a.get_value()]
        a.increment()
        a.decrement()
        seen.append(a.get_value())
        seen.append(a.reset())
        seen.append(a.get_value())
        return seen

    j, t = _both(run)
    assert t == j == [8, 8, 8, 0]


def test_adder_multithreaded_writes_alike():
    def run(pkg):
        a = pkg.bvar.Adder()

        def work():
            for _ in range(1000):
                a << 1

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return a.get_value(), len(a._agents)

    j, t = _both(run)
    assert t == j == (8000, 8)


def test_maxer_miner_alike():
    def run(pkg):
        mx, mn = pkg.bvar.Maxer(), pkg.bvar.Miner()
        empty = (mx.get_value(), mn.get_value())
        for v in (3, 9, 1):
            mx << v
            mn << v
        return empty, mx.get_value(), mn.get_value()

    j, t = _both(run)
    assert t == j == ((0, 0), 9, 1)


# ---------------------------------------------------------------------------
# The expose registry.
# ---------------------------------------------------------------------------

def test_expose_and_dump_alike():
    def run(pkg):
        a = pkg.bvar.Adder("test_torch_counter_one")
        b = pkg.bvar.IntRecorder("test_torch_counter_two")
        s = pkg.bvar.Status("test_torch_counter_three", 2.5)
        a << 7
        b << 10
        b << 20
        listed = pkg.bvar.list_exposed("test_torch_counter*")
        found = pkg.bvar.find_exposed("test_torch_counter_one") is a
        dump = pkg.bvar.dump_exposed("test_torch_counter*")
        for v in (a, b, s):
            v.hide()
        gone = pkg.bvar.find_exposed("test_torch_counter_one") is None
        return listed, found, dump, gone

    j, t = _both(run)
    assert t == j
    assert dict(t[2]) == {"test_torch_counter_one": "7",
                          "test_torch_counter_three": "2.5",
                          "test_torch_counter_two": "15"}


def test_name_normalization_alike():
    names = ("Foo Bar-baz::Qux", "EchoService.Echo", "__a__b__", "x")
    j, t = _both(lambda pkg: [pkg.bvar.to_underscored_name(n)
                              for n in names])
    assert t == j
    assert t[0] == "foo_bar_baz_qux"


def test_duplicate_name_rejected_alike():
    """The second variable exposed under a taken name is refused and keeps
    counting unexposed: two instances never fight over a name."""
    def run(pkg):
        a = pkg.bvar.Adder("test_torch_dup_name")
        b = pkg.bvar.Adder("test_torch_dup_name")
        c = pkg.bvar.Adder()
        refused = (b.name, c.expose("test_torch_dup_name"))
        a << 1
        b << 2
        exposed = pkg.bvar.find_exposed("test_torch_dup_name") is a
        dump = pkg.bvar.dump_exposed("test_torch_dup_name")
        a.hide()
        return refused, exposed, b.get_value(), dump

    j, t = _both(run)
    assert t == j == ((None, False), True, 2,
                      [("test_torch_dup_name", "1")])


def test_status_passive_and_gflag_alike():
    def run(pkg):
        s = pkg.bvar.Status(value=41)
        s.set_value(42)
        p = pkg.bvar.PassiveStatus(lambda: 7)
        pkg.flags.define_flag("test_torch_bvar_gflag", 3, "a test flag")
        g = pkg.bvar.GFlag("test_torch_bvar_gflag")
        out = (s.get_value(), p.get_value(), g.get_value(), g.name,
               g.describe())
        g.hide()
        return out

    j, t = _both(run)
    assert t == j == (42, 7, 3, "test_torch_bvar_gflag", "3")


def test_count_exposed_moves_alike():
    def run(pkg):
        n0 = pkg.bvar.count_exposed()
        v = pkg.bvar.Adder("test_torch_count_exposed")
        n1 = pkg.bvar.count_exposed()
        v.hide()
        return n1 - n0, pkg.bvar.count_exposed() - n0

    j, t = _both(run)
    assert t == j == (1, 0)


# ---------------------------------------------------------------------------
# Windows, on the sampler's tick.
# ---------------------------------------------------------------------------

def test_window_delta_alike():
    def run(pkg):
        a = pkg.bvar.Adder()
        w = pkg.bvar.Window(a, window_size=10)
        a << 100
        _tick(pkg)
        first = w.get_value()
        a << 50
        _tick(pkg)
        return first, w.get_value(), w.window_size()

    j, t = _both(run)
    assert t == j == (100, 150, 10)


def test_window_slides_past_its_size_alike():
    """After more ticks than the window holds, the oldest deltas leave."""
    def run(pkg):
        a = pkg.bvar.Adder()
        w = pkg.bvar.Window(a, window_size=2)
        seen = []
        for v in (10, 20, 30, 40):
            a << v
            _tick(pkg)
            seen.append(w.get_value())
        return seen

    j, t = _both(run)
    assert t == j == [10, 30, 50, 70]


def test_per_second_alike():
    def run(pkg):
        a = pkg.bvar.Adder()
        q = pkg.bvar.PerSecond(a, window_size=10)
        zero = q.get_value()
        a << 500
        _tick(pkg)
        v, span = q._sampler.value_in_window(10)
        return zero, v, span > 0 and q.get_value() == v / span

    j, t = _both(run)
    assert t == j == (0, 500, True)


def test_window_over_maxer_alike():
    def run(pkg):
        m = pkg.bvar.Maxer()
        w = pkg.bvar.Window(m, window_size=10)
        m << 3
        _tick(pkg)
        m << 9
        _tick(pkg)
        return w.get_value()

    j, t = _both(run)
    assert t == j == 9


# ---------------------------------------------------------------------------
# Latency recorders.
# ---------------------------------------------------------------------------

def test_latency_recorder_record_and_read_alike():
    def run(pkg):
        _seed(7)
        rec = pkg.bvar.LatencyRecorder()
        for us in (100, 200, 300, 400, 500):
            rec << us
        return (rec.count(), rec.latency(), rec.max_latency(),
                rec._percentile.get_value().get_number(0.5))

    j, t = _both(run)
    assert t == j == (5, 300.0, 500, 300)


def test_windowed_percentile_alike():
    """1,000 samples overflow the 254-slot reservoir: the replacement
    draws come from fast_rand, seeded alike, so the percentiles agree."""
    def run(pkg):
        _seed(1234)
        rec = pkg.bvar.LatencyRecorder(window_size=10)
        for us in range(1, 1001):
            rec << us
        _tick(pkg)
        return [rec.latency_percentile(r) for r in (.5, .9, .99, .999)]

    j, t = _both(run)
    assert t == j
    assert 400 <= t[0] <= 600 and t[2] >= 900


def test_latency_recorder_exposed_family_alike():
    def run(pkg):
        _seed(11)
        rec = pkg.bvar.LatencyRecorder("test_torch_method_a")
        for us in (100, 300):
            rec << us
        _tick(pkg)
        names = pkg.bvar.list_exposed("test_torch_method_a*")
        dump = dict(pkg.bvar.dump_exposed("test_torch_method_a*"))
        dump.pop("test_torch_method_a_qps")     # over the real tick span
        return names, dump

    j, t = _both(run)
    assert t == j
    names, dump = t
    assert {"test_torch_method_a_latency", "test_torch_method_a_qps",
            "test_torch_method_a_latency_99",
            "test_torch_method_a_max_latency",
            "test_torch_method_a_count"} <= set(names)
    assert dump["test_torch_method_a_latency"] == "200"
    assert dump["test_torch_method_a_count"] == "2"


def test_int_recorder_alike():
    def run(pkg):
        r = pkg.bvar.IntRecorder()
        empty = r.average()
        r << 10
        r << 20
        return empty, r.average(), r.sum(), r.count(), r.get_value()

    j, t = _both(run)
    assert t == j == (0.0, 15.0, 30, 2, 15.0)


@pytest.mark.parametrize("pkg", BOTH, ids=["jax", "torch"])
def test_batched_record_shares_one_lock(pkg):
    """Under the default flag a thread's five agents share ONE lock (a
    record is one acquisition), and reads stay exact across threads."""
    assert pkg.flags.get_flag("bvar_batched_record") is True
    rec = pkg.bvar.LatencyRecorder(window_size=10)
    rec << 100
    lock, s, c, m, n, p, _ident = rec._tls_fast.agents
    assert lock is not None
    assert s.lock is lock and c.lock is lock and m.lock is lock
    assert n.lock is lock and p.lock is lock

    def w(v):
        for _ in range(2000):
            rec << v

    ts = [threading.Thread(target=w, args=(v,)) for v in (10, 30)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert rec.count() == 4001
    assert rec.max_latency() == 100
    _tick(pkg)
    assert rec.latency_percentile(0.5) > 0


@pytest.mark.parametrize("pkg", BOTH, ids=["jax", "torch"])
def test_unbatched_flag_restores_per_agent_locks(pkg):
    prev = pkg.flags.get_flag("bvar_batched_record")
    pkg.flags.set_flag("bvar_batched_record", False)
    try:
        rec = pkg.bvar.LatencyRecorder()
        rec << 50
        lock, s, c, *_rest = rec._tls_fast.agents
        assert lock is None
        assert s.lock is not c.lock
        assert rec.count() == 1 and rec.latency() == 50.0
    finally:
        pkg.flags.set_flag("bvar_batched_record", prev)


# ---------------------------------------------------------------------------
# Families, the collector, the default variables.
# ---------------------------------------------------------------------------

def test_multi_dimension_alike():
    def run(pkg):
        md = pkg.bvar.MultiDimension("test_torch_md_requests",
                                     ["method", "status"], pkg.bvar.Adder)
        md.get_stats(["echo", "ok"]) << 3
        md.get_stats(["echo", "err"]) << 1
        md.get_stats(["echo", "ok"]) << 2
        out = [md.count_stats(), md.get_stats(["echo", "ok"]).get_value(),
               md.describe(), md.has_stats(["echo", "err"])]
        md.delete_stats(["echo", "err"])
        out.append(md.count_stats())
        with pytest.raises(ValueError):
            md.get_stats(["echo"])
        md.hide()
        return out

    j, t = _both(run)
    assert t == j
    assert t[0] == 2 and t[1] == 5 and 'method="echo"' in t[2]


def test_collector_speed_limit_alike():
    def run(pkg):
        limit = pkg.bvar.CollectorSpeedLimit(max_samples_per_second=5)
        accepted = sum(1 for _ in range(100) if limit.is_sampled())
        return accepted, limit.submitted

    j, t = _both(run)
    assert t == j == (5, 100)


@pytest.mark.parametrize("pkg", BOTH, ids=["jax", "torch"])
def test_collector_submit_and_process(pkg):
    class Sample(pkg.bvar.Collected):
        def __init__(self, v):
            self.v = v

    got = []
    c = pkg.bvar.Collector.instance()
    c.register_processor(Sample, lambda batch: got.extend(s.v for s in batch))
    c.submit(Sample(1))
    c.submit(Sample(2))
    c.flush_for_test()
    # the collector's own thread may have taken the batch first
    deadline = threading.Event()
    for _ in range(200):
        if len(got) >= 2:
            break
        deadline.wait(0.01)
    assert sorted(got) == [1, 2]


def test_default_variables_alike():
    """The process block is the same set in both; the port's device
    variables name the card (``cuda_*``) where the JAX package's name the
    TPU (``tpu_*``)."""
    def run(pkg):
        pkg.bvar.expose_default_variables()
        return dict(pkg.bvar.dump_exposed("process_*"))

    j, t = _both(run)
    assert set(t) == set(j)
    assert int(t["process_pid"]) == int(j["process_pid"]) > 0
    assert int(t["process_thread_count"]) >= 1
    dev = dict(tbvar.dump_exposed("cuda_*"))
    assert set(dev) == {"cuda_device_count", "cuda_memory_bytes_in_use"}
    ici = dict(tbvar.dump_exposed("ici_*"))
    assert {"ici_bytes_moved", "ici_device_bytes_moved"} <= set(ici)


def test_an_idle_percentile_is_not_merged_again():
    """The window sampler repeats an unchanged reservoir's last snapshot
    instead of merging it again (the merge's downsample is the costly
    part of a tick), and merges afresh after a record."""
    rec = tbvar.LatencyRecorder(window_size=10)
    for us in range(1, 600):
        rec << us
    sampler = rec._win_percentile._sampler
    _tick(PORT)
    first = sampler.samples[-1][1]
    _tick(PORT)
    assert sampler.samples[-1][1] is first
    rec << 5000
    _tick(PORT)
    fresh = sampler.samples[-1][1]
    assert fresh is not first and fresh.num_added == first.num_added + 1
