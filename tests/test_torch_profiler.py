"""The profiler: the JAX package's ``tests/test_profiler.py`` (CPU
hotspots, contention, the contention page) on both packages, the
profiler's builtin pages over RPC on the port, and its device trace on
``torch.profiler``."""
from __future__ import annotations

import glob
import json
import threading
import time

import pytest

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu.rpc import profiler as jprof
from brpc_tpu.rpc.builtin import register_builtin_services as jregister
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import profiler as tprof
from brpc_tpu_torch.rpc.builtin import register_builtin_services
from brpc_tpu_torch.rpc.builtin.rpc_service import JsonMsg
from brpc_tpu_torch.rpc.controller import server_controller_pool

PKGS = [pytest.param((jprof, jrpc, jregister), id="jax"),
        pytest.param((tprof, rpc, register_builtin_services), id="port")]


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    yield
    deadline = time.monotonic() + 2.0
    while (rpc.list_sockets() or server_controller_pool.live()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()


@pytest.mark.parametrize("pkg", PKGS)
class TestCpuProfile:
    def test_profile_call(self, pkg):
        profiler = pkg[0]

        def busy():
            return sum(i * i for i in range(50000))

        result, report = profiler.profile_call(busy)
        assert result == sum(i * i for i in range(50000))
        assert "cumulative" in report

    def test_profile_for(self, pkg):
        report = pkg[0].profile_for(0.05, top=5)
        assert "function calls" in report


@pytest.mark.parametrize("pkg", PKGS)
class TestContention:
    def test_contended_lock_sampled(self, pkg):
        profiler = pkg[0]
        profiler.enable_contention_profiler(True)
        try:
            m = profiler.ContentionMutex()

            def holder():
                with m:
                    time.sleep(0.15)

            t = threading.Thread(target=holder)
            t.start()
            time.sleep(0.02)
            with m:          # waits ~130 ms: sampled
                pass
            t.join()
            rows = profiler.contention_profile()
            assert rows
            assert sum(r[2] for r in rows) > 0.05
        finally:
            profiler.enable_contention_profiler(False)

    def test_uncontended_not_sampled(self, pkg):
        profiler = pkg[0]
        profiler.enable_contention_profiler(True)
        try:
            m = profiler.ContentionMutex()
            for _ in range(100):
                with m:
                    pass
            assert profiler.contention_profile() == []
        finally:
            profiler.enable_contention_profiler(False)


@pytest.mark.parametrize("pkg", PKGS)
def test_contention_page(pkg):
    _, pkg_rpc, register = pkg
    server = pkg_rpc.Server()
    register(server)
    try:
        ctype, body = server._builtin.dispatch("contention", {"enable": "1"})
        assert "enabled" in body
        ctype, body = server._builtin.dispatch("contention", {})
        assert "total_wait_s" in body and "enabled: True" in body
    finally:
        server._builtin.dispatch("contention", {"enable": "0"})


def test_profiler_pages_match_jax_and_answer_over_rpc():
    """The profiler's pages exist on both packages, and the port answers
    them as RPC methods (``brpc_tpu.Builtin.Call``)."""
    jsrv = jrpc.Server()
    jregister(jsrv)
    server = rpc.Server()
    assert server.start("mem://prof-pages") == 0
    pages = ("hotspots", "contention", "pprof/cmdline", "pprof/profile",
             "pprof/symbol")
    try:
        for page in pages:
            assert page in jsrv._builtin.paths()
            assert page in server._builtin.paths()
        assert server._builtin.dispatch("pprof/symbol", {}) == \
            jsrv._builtin.dispatch("pprof/symbol", {})
        ch = rpc.Channel()
        ch.init("mem://prof-pages", options=rpc.ChannelOptions(
            timeout_ms=10000))
        for page, query, word in (
                ("hotspots", {"seconds": "0.05", "top": "5"},
                 "function calls"),
                ("pprof/profile", {"seconds": "0.05"}, "function calls"),
                ("pprof/cmdline", {}, "python"),
                ("contention", {}, "total_wait_s")):
            cntl = rpc.Controller()
            r = ch.call_method("brpc_tpu.Builtin.Call", cntl,
                               JsonMsg(page=page, query=query), JsonMsg)
            assert not cntl.failed(), cntl.error_text
            assert r["status"] == 200 and word in r["body"], (page, r)
        ch.close()
    finally:
        server.stop()


def test_device_trace_writes_a_trace(tmp_path):
    """``start_device_trace`` / ``stop_device_trace`` run torch.profiler
    (the CPU activity here; CUDA too on a card) and write a Chrome trace
    into the directory; a second start while one runs is refused."""
    import torch
    assert tprof.start_device_trace(str(tmp_path))
    try:
        assert not tprof.start_device_trace(str(tmp_path))
        torch.ones(64).add_(1).sum()
    finally:
        assert tprof.stop_device_trace()
    assert not tprof.stop_device_trace()
    traces = glob.glob(str(tmp_path / "trace.*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
