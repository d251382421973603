"""``sweeps/overload_ab.py --stages``: the overload leg's latency split into
its stages, on the port and on the JAX package, read off each call's
client and server spans."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SWEEP = os.path.join(_REPO, "sweeps", "overload_ab.py")


@pytest.fixture(scope="module")
def sweep():
    spec = importlib.util.spec_from_file_location("overload_ab", _SWEEP)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spans(span_mod):
    """A client span and its server span on one clock (µs): issued at
    +100, cut at +400, input queue 300, admission 50, parse 10, handler
    20,000, encode 100, write 200 from +20,900, the client span ending at
    +21,000."""
    cli = span_mod.Span("Echo.Echo", True)
    srv = span_mod.Span("Echo.Echo", False, cli.trace_id, cli.span_id)
    t = cli.start_us = 1_000_000
    cli.annotations = [(t + 100, "issue try=0 to ici://5")]
    srv.start_us = t + 650
    srv.annotations = [(t + 700, "queue_us=300"), (t + 760, "queue_us=50"),
                       (t + 780, "parse_us=10"),
                       (t + 20_790, "handler_us=20000"),
                       (t + 20_900, "encode_us=100"),
                       (t + 21_100, "write_us=200")]
    cli.end_us = t + 21_000
    return [cli, srv]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_stage_row_sums_to_the_latency(sweep, package):
    if package == "jax":
        from brpc_tpu.rpc import span as span_mod
    else:
        from brpc_tpu_torch.rpc import span as span_mod
    row = sweep._stage_row(_spans(span_mod), 21_400.0)
    assert row == {
        "client_send": 100.0, "request_wire": 300.0, "input_queue": 300.0,
        "admission_wait": 50.0, "parse": 10.0, "handler": 20_000.0,
        "encode": 100.0, "server_other": 40.0, "response": 100.0,
        "client_rest": 400.0, "write": 200.0, "latency": 21_400.0}
    assert sum(row[k] for k in sweep._STAGES) == row["latency"]
    # a call without its client span is left out
    assert sweep._stage_row(_spans(span_mod)[1:], 21_400.0) is None


def test_stages_sweep_splits_both_packages(sweep):
    """One round of the sweep with ``--stages`` (both legs, each in a
    process of its own, on a warm connection): every served priority-0
    call of both windows is split, the unloaded window waits in no
    admission queue, and the summary gives each package's ranges."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, _SWEEP, "--rounds", "1", "--stages"], cwd=_REPO,
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert sorted(r["package"] for r in rows) == ["jax", "port"]
    for r in rows:
        un, over = r["stages"]["unloaded"], r["stages"]["overload"]
        # 50 rps for 1.2 s, every call traced
        assert un["traced"] >= 40, r["package"]
        assert over["traced"] > 0, r["package"]
        assert un["admission_wait"]["p99"] == 0.0
        assert un["handler"]["p50"] >= sweep.SERVICE_MS * 1000
        for split in (un, over):
            assert set(sweep._READ) <= set(split)
            assert split["request_wire"]["p50"] >= -1.0
            assert split["response"]["p50"] >= 0.0
    for which in ("port", "jax"):
        summary = [ln for ln in lines
                   if ln.startswith(f"{which}: stages, ms over the rounds ")]
        assert len(summary) == 1
        ranges = json.loads(summary[0].split("rounds ", 1)[1])
        assert "unloaded.client_rest.slowest_tenth" in ranges
        assert "overload.admission_wait.p99" in ranges
