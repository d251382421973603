"""The port's C++ under ThreadSanitizer and AddressSanitizer (slow-marked),
the twin of ``tests/test_sanitizers.py``.

For each sanitizer the test builds the port's two native libraries from
``brpc_tpu_torch/csrc/`` with ``-fsanitize=thread`` or
``-fsanitize=address``: ``libici_native.so`` (``ici_native.cpp`` and
``rpc_native.cpp``, as ``butil/native.py`` builds it) and
``libfabric_native.so`` (``fabric_native.cpp``).  Each goes into a
directory of its own under the git-ignored ``brpc_tpu_torch/_build/``
(``sanitize-tsan``, ``sanitize-asan``), so the production libraries are
never overwritten.  It links the smoke mains ``csrc/ici_smoke.cpp`` and
``csrc/fabric_smoke.cpp`` against them and runs both with
``halt_on_error=1``, so any report is a nonzero exit.

The smokes are the counterparts of ``native/ici_smoke.cpp`` and
``native/fabric_smoke.cpp`` on the port's ABI: the batched upcall ABI
under concurrent callers with a cross-thread responder and an unlisten
mid-traffic, native attachment custody through ``call4``; the bulk conn
under concurrent senders and claimers, a dead-conn claim, the shm ring
and its striped form with wraparound, a teardown mid-transfer and the
stripe-kill chaos, then a quiesce.

``native/core_test.cpp`` has no counterpart: the port's C++ has no fiber
or pool core (ROADMAP queue 1, the native loader's bindings).

``csrc/tsan_compat.h`` routes the timed condition-variable waits through
an intercepted clock under ``-fsanitize=thread``, as the JAX core's copy
does.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "brpc_tpu_torch", "csrc")
BUILD = os.path.join(REPO, "brpc_tpu_torch", "_build")

pytestmark = pytest.mark.slow

_COMMON = ["-O1", "-g", "-fno-omit-frame-pointer", "-fPIC", "-pthread",
           "-std=c++17"]
_LIBS = {"ici_native": ["ici_native.cpp", "rpc_native.cpp"],
         "fabric_native": ["fabric_native.cpp"]}
_SMOKES = {"ici_smoke": ("ici_native", "ALL ICI SMOKE PASSED"),
           "fabric_smoke": ("fabric_native", "ALL FABRIC SMOKE PASSED")}


def _gxx():
    return shutil.which(os.environ.get("CXX", "g++"))


def _toolchain_ok(flag: str) -> bool:
    gxx = _gxx()
    if gxx is None:
        return False
    probe = subprocess.run(
        [gxx, flag, "-x", "c++", "-", "-o", "/dev/null", "-pthread"],
        input=b"int main(){return 0;}", capture_output=True)
    return probe.returncode == 0


def _run(cmd, env=None, timeout=600):
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=timeout)
    return res.returncode, res.stdout + res.stderr


def _build(tag: str, flag: str) -> str:
    out = os.path.join(BUILD, f"sanitize-{tag}")
    os.makedirs(out, exist_ok=True)
    for lib, units in _LIBS.items():
        rc, text = _run([_gxx(), *_COMMON, flag, "-shared",
                         "-fvisibility=hidden", "-Wl,-Bsymbolic",
                         "-I", CSRC, "-o", os.path.join(out, f"lib{lib}.so"),
                         *[os.path.join(CSRC, u) for u in units]])
        assert rc == 0, f"{tag} build of lib{lib}.so failed:\n{text[-4000:]}"
    for smoke, (lib, _) in _SMOKES.items():
        rc, text = _run([_gxx(), *_COMMON, flag, "-I", CSRC,
                         "-o", os.path.join(out, smoke),
                         os.path.join(CSRC, f"{smoke}.cpp"), "-L", out,
                         f"-l{lib}", "-Wl,-rpath,$ORIGIN"])
        assert rc == 0, f"{tag} build of {smoke} failed:\n{text[-4000:]}"
    return out


@pytest.mark.parametrize("tag,flag,options", [
    ("tsan", "-fsanitize=thread", {"TSAN_OPTIONS": "halt_on_error=1"}),
    ("asan", "-fsanitize=address",
     {"ASAN_OPTIONS": "halt_on_error=1:detect_leaks=1"}),
])
def test_port_sanitizer_build_and_smoke(tag, flag, options):
    if not _toolchain_ok(flag):
        pytest.skip(f"toolchain lacks {flag}")
    out = _build(tag, flag)
    env = dict(os.environ, **options)
    for smoke, (_lib, passed) in _SMOKES.items():
        rc, text = _run([os.path.join(out, smoke)], env=env)
        tail = text[-4000:]
        assert rc == 0, f"{tag} {smoke} exited {rc}:\n{tail}"
        assert passed in text, tail
        # halt_on_error=1 makes any report fatal; belt and braces
        assert "WARNING: ThreadSanitizer" not in text, tail
        assert "ERROR: AddressSanitizer" not in text, tail
        assert "LeakSanitizer" not in text, tail
