"""Run a JAX package test file over both packages.

``mirror(path, namespace)`` loads the test file twice: as it is, and with
every ``brpc_tpu`` module it imports swapped for its ``brpc_tpu_torch``
counterpart (plus the file's own ``swaps``, for what lives elsewhere in
the port).  Each test class and module-level test of the two copies lands
in ``namespace`` under the package's name, ``TestFooJax`` / ``TestFooPort``
and ``test_foo_jax`` / ``test_foo_port``, so pytest collects every test of
the file once per package with its fixtures intact.  The file on disk is
read, never edited.
"""
from __future__ import annotations

import gc
import os
import re
import sys
import time
import types
from typing import Dict, Iterable, Optional, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = re.compile(r"\bbrpc_tpu\b(?!_torch)")


def load(path: str, port: bool,
         swaps: Iterable[Tuple[str, str]] = ()) -> types.ModuleType:
    """The test module at ``path`` (relative to the repo), on the JAX
    package or, with ``port``, on the port."""
    full = os.path.join(REPO, path)
    with open(full) as f:
        src = f.read()
    if port:
        for old, new in swaps:
            assert old in src, f"{path}: {old!r} not found"
            src = src.replace(old, new)
        src = _PKG.sub("brpc_tpu_torch", src)
    stem = os.path.splitext(os.path.basename(path))[0]
    name = f"tests._mirror_{'port' if port else 'jax'}_{stem}"
    mod = types.ModuleType(name)
    mod.__file__ = full
    mod.__package__ = "tests"
    sys.modules[name] = mod
    exec(compile(src, full, "exec"), mod.__dict__)
    # the copies run beside the original module in one worker: names
    # they register (mem:// listeners) must not collide with its own
    for counter in ("_seq",):
        seq = mod.__dict__.get(counter)
        if isinstance(seq, list) and seq and isinstance(seq[0], int):
            seq[0] += 100_000 if port else 200_000
    return mod


def mirror(path: str, namespace: Dict[str, object],
           swaps: Iterable[Tuple[str, str]] = (),
           names: Optional[Iterable[str]] = None, prefix: str = "") -> None:
    """Publish the tests of ``path`` on both packages into ``namespace``
    (a test module's ``globals()``): every test class and module-level
    test, or only the classes ``names``, as ``Test<prefix><Name>Jax`` /
    ``...Port`` (``test_<name>_jax`` / ``..._port``)."""
    for port in (False, True):
        mod = load(path, port, swaps)
        tag = "Port" if port else "Jax"
        for key, obj in list(mod.__dict__.items()):
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if names is not None and key not in names:
                continue
            if key.startswith("Test") and isinstance(obj, type):
                name = f"Test{prefix}{key[4:]}{tag}"
                namespace[name] = type(name, (obj,), {
                    "__module__": namespace["__name__"]})
            elif key.startswith("test_") and callable(obj):
                namespace[f"{key}_{tag.lower()}"] = obj


@pytest.fixture(scope="module", autouse=True)
def drain_sockets():
    """Every connection a module's port servers and channels opened is
    gone at its end (import this fixture into the test module)."""
    yield
    from brpc_tpu_torch.rpc.socket import list_sockets
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and list_sockets():
        gc.collect()
        time.sleep(0.02)
    assert not list_sockets()
