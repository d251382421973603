"""The port's twin of ``tests/test_examples.py``: every one of its 27
example names run as ``brpc_tpu_torch.examples.<name>.main(["--device",
"cpu"])``, in JAX-free interpreters of their own, one per group, one
group after another.  Each example returns 0, leaves no server behind
for the next one in its interpreter, and loads neither JAX nor the JAX
package.  Where an example prints a deterministic result, its lines
equal the JAX example's, run here in this process.

``multi_threaded_echo`` takes ``--threads 4 --seconds 0.5``, where the JAX
file calls ``main(threads=4, seconds=0.5)``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_examples.py's list, without the package prefix
EXAMPLES = [
    "echo_client_server", "multi_threaded_echo", "asynchronous_echo",
    "streaming_echo", "parallel_echo", "partition_echo", "selective_echo",
    "backup_request", "dynamic_partition_echo", "cancel_rpc", "ici_echo",
    "http_server", "auto_concurrency_limiter", "param_server",
    "native_echo", "native_async_pool", "mongo_service", "cascade_echo",
    "grpc_echo", "grpc_interop", "redis_kv", "memcache_client",
    "thrift_echo", "nshead_extension", "session_data_and_thread_local",
    "multi_threaded_echo_fns", "rtmp_relay",
]
# one interpreter each: host echoes, the device plane's examples, the
# protocols
GROUPS = [
    ["echo_client_server", "multi_threaded_echo", "asynchronous_echo",
     "auto_concurrency_limiter", "cascade_echo", "multi_threaded_echo_fns",
     "native_echo", "native_async_pool", "session_data_and_thread_local"],
    ["ici_echo", "streaming_echo", "parallel_echo", "partition_echo",
     "selective_echo", "backup_request", "dynamic_partition_echo",
     "cancel_rpc", "param_server"],
    ["http_server", "grpc_echo", "grpc_interop", "redis_kv",
     "memcache_client", "mongo_service", "thrift_echo",
     "nshead_extension", "rtmp_relay"],
]
EXTRA = {"multi_threaded_echo": ["--threads", "4", "--seconds", "0.5"]}
# lines whose text does not depend on timing: each equals the JAX
# example's (a latency in the line is cut off first)
DETERMINISTIC = ["asynchronous_echo", "cascade_echo", "grpc_echo",
                 "grpc_interop", "multi_threaded_echo_fns", "redis_kv",
                 "memcache_client", "mongo_service", "thrift_echo",
                 "nshead_extension", "rtmp_relay"]

_GROUP = r"""
import contextlib, importlib, io, json, sys, time, traceback
names, extra = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for name in names:
    mod = importlib.import_module("brpc_tpu_torch.examples." + name)
    buf = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["--device", "cpu"] + extra.get(name, []))
    except BaseException:
        rc = "raised: " + traceback.format_exc()
    out[name] = {"rc": rc, "stdout": buf.getvalue(),
                 "s": time.monotonic() - t0}
out["_foreign"] = sorted(
    m for m in sys.modules if m in ("jax", "brpc_tpu", "examples")
    or m.startswith(("jax.", "jaxlib", "brpc_tpu.", "examples.")))
sys.stdout.write("RESULT " + json.dumps(out) + "\n")
sys.stdout.flush()
"""


@pytest.fixture(scope="module")
def port_runs() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    runs = {}
    for g in GROUPS:
        p = subprocess.run(
            [sys.executable, "-c", _GROUP, json.dumps(g), json.dumps(EXTRA)],
            cwd=_REPO, env=env, capture_output=True, text=True, timeout=100)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        assert p.returncode == 0 and lines, (
            f"rc {p.returncode}\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}")
        got = json.loads(lines[-1][len("RESULT "):])
        assert got.pop("_foreign") == []
        runs.update(got)
    return runs


def test_groups_cover_the_jax_list():
    names = [n for g in GROUPS for n in g]
    assert sorted(names) == sorted(EXAMPLES) and len(set(names)) == 27
    for name in EXAMPLES:
        assert os.path.exists(os.path.join(
            _REPO, "brpc_tpu_torch", "examples", f"{name}.py")), name


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, port_runs):
    run = port_runs[name]
    assert run["rc"] == 0, run


def _lines(text: str) -> list:
    text = re.sub(r" \(2 hops, latency=\d+us\)", "", text)
    return sorted(ln for ln in text.splitlines() if ln.strip())


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_example_prints_what_jax_prints(name, port_runs):
    import importlib
    sys.path.insert(0, _REPO)
    mod = importlib.import_module(f"examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    assert _lines(port_runs[name]["stdout"]) == _lines(buf.getvalue())
