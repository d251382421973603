"""Two repairs of the suite's steadiness.

* Exit: a process whose scheduler workers are inside torch calls when the
  interpreter finalizes must exit cleanly.  Before the scheduler joined its
  workers at exit, such a worker was unwound through torch's C++ frames
  and the process aborted ("terminate called without an active
  exception", rc 134 or -6): the pod member's abort in loaded runs.
* The JAX package's native core: six test workers that import their files
  at once race its unlocked build, and a worker that loads a library still
  being linked sees none.  ``tests.torch_procs.jax_core_available`` waits
  the build out under a lock, so the port's tests that compare against the
  JAX core do not skip on that race.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import types

import pytest

from tests import torch_procs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_EXIT_PROBE = r"""
import sys, time
import torch
from brpc_tpu_torch.bthread import scheduler
a = torch.randn(384, 384)
started = []

def work():
    started.append(1)
    t = time.monotonic()
    while time.monotonic() - t < 1.0:
        torch.mm(a, a)

for _ in range(4):
    scheduler.start_background(work)
while len(started) < 4:
    time.sleep(0.001)
time.sleep(0.05)
print("exiting", flush=True)
"""


@pytest.mark.parametrize("round_", range(3))
def test_exit_with_workers_inside_torch_calls_is_clean(round_):
    out = subprocess.run([sys.executable, "-c", _EXIT_PROBE], cwd=_REPO,
                         capture_output=True, text=True, timeout=60)
    assert "terminate called" not in out.stderr, out.stderr[-2000:]
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    assert out.stdout.strip() == "exiting"


def test_quiesce_lets_the_running_tasklet_finish():
    from brpc_tpu_torch.bthread.scheduler import TaskControl
    control = TaskControl(concurrency=2)
    finished = threading.Event()

    def slow():
        time.sleep(0.2)
        finished.set()

    from brpc_tpu_torch.bthread.scheduler import Tasklet
    control.submit(Tasklet(slow, (), {}, "slow"), False)
    time.sleep(0.05)
    assert control.quiesce(timeout=5.0)
    assert finished.is_set()
    assert not any(t.is_alive() for t in control._workers)


def _fake_native(monkeypatch, answers):
    """``brpc_tpu.butil.native.load`` answering from ``answers`` (then the
    last answer), and ``make`` recorded instead of run."""
    from brpc_tpu.butil import native
    seq = list(answers)
    calls = {"load": 0, "make": 0}

    def load():
        calls["load"] += 1
        return seq.pop(0) if len(seq) > 1 else seq[0]

    def run(cmd, **kw):
        assert cmd[:2] == ["make", "-C"] and cmd[-1] == "libbrpc_tpu_core.so"
        calls["make"] += 1
        return types.SimpleNamespace(returncode=0)

    monkeypatch.setattr(native, "load", load)
    monkeypatch.setattr(torch_procs.subprocess, "run", run)
    monkeypatch.setattr(torch_procs.time, "sleep", lambda s: None)
    return calls


def test_jax_core_available_waits_out_a_concurrent_build(monkeypatch):
    """The library another worker is still linking does not load twice,
    then does: the answer is True, after a locked make of its own."""
    calls = _fake_native(monkeypatch, [None, None, object()])
    assert torch_procs.jax_core_available(timeout=30) is True
    assert calls["make"] >= 1 and calls["load"] == 3


def test_jax_core_available_is_false_without_a_toolchain(monkeypatch):
    calls = _fake_native(monkeypatch, [None])
    assert torch_procs.jax_core_available(timeout=0) is False
    assert calls["make"] == 1
