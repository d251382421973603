"""The port's custody census, and its children run under both runtime
layers of the debug tooling.

The census: the ledger leg of the root census, for the port's ledger.

The root ``tests/conftest.py`` census reads only the JAX package's ledger
(``brpc_tpu.butil.custody_ledger``).  ``custody_census`` reads the
port's, ``brpc_tpu_torch.butil.custody_ledger``: it takes the
outstanding holds as a multiset of (resource, key, acquiring site)
before each test and fails the test on a net-new hold that survives a
2 s settle after it.  Import the fixture into a test module whose paths
carry the port's hooks (``from tests.torch_census import
custody_census  # noqa: F401``).  ``tests/conftest.py`` exports
``BRPC_TPU_DEBUG_CUSTODY=1`` before any import, so the port's ledger is
on.  A test that carries ``@pytest.mark.allow_leaks(...)`` (its JAX
original does) is not checked, as in the root census.

The layers: ``debug_layers()`` runs the children that
``tests/torch_procs.py`` starts inside it under the lock-order layer
(``butil/debug_sync.py``) and the custody ledger
(``butil/custody_ledger.py``), with the four environment variables of
``tests/test_chaos_fabric.py``'s children.  ``layers.body(body, tag)``
makes each child dump its two reports at its exit under its own names,
and ``layers.check(tag, results)`` asserts them as that file's parent
does: an acyclic lock graph, no long hold, no outstanding custody hold
and no unmatched strict release, for every child that exited 0 (a child
killed on purpose writes none).
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import tempfile
import time

import pytest

# the port's two layers are imported here, before any test sets their
# environment: their flags and report hooks in this process keep the
# values the process started with
import brpc_tpu_torch.butil.custody_ledger  # noqa: F401
import brpc_tpu_torch.butil.debug_sync  # noqa: F401

SETTLE_S = 2.0
_LAYER_ENV = ("BRPC_TPU_DEBUG_LOCK_ORDER", "BRPC_TPU_DEBUG_SYNC_REPORT",
              "BRPC_TPU_DEBUG_CUSTODY", "BRPC_TPU_CUSTODY_REPORT")


def _holds() -> dict:
    from brpc_tpu_torch.butil import custody_ledger
    out: dict = {}
    for r in custody_ledger.outstanding():
        k = (r["resource"], tuple(r["key"]), r["site"])
        out[k] = out.get(k, 0) + 1
    return out


def _leaks(base: dict) -> list:
    leaks = []
    for k, n in _holds().items():
        extra = n - base.get(k, 0)
        if extra > 0:
            resource, key, site = k
            leaks.append(f"port custody ledger: {extra} unreleased "
                         f"{resource!r} hold(s) acquired at {site} "
                         f"(key={list(key)})")
    return leaks


@pytest.fixture(autouse=True)
def custody_census(request):
    base = _holds()
    yield
    if request.node.get_closest_marker("allow_leaks") is not None:
        return
    deadline = time.monotonic() + SETTLE_S
    leaks = _leaks(base)
    while leaks and time.monotonic() < deadline:
        # a view or a controller released from __del__ waits for the GC
        gc.collect()
        time.sleep(0.05)
        leaks = _leaks(base)
    if leaks:
        pytest.fail("port custody census: test %s leaked:\n  %s"
                    % (request.node.nodeid, "\n  ".join(leaks)),
                    pytrace=False)


class _Layers:
    def __init__(self, report_dir: str):
        self.dir = report_dir

    def _paths(self, tag, pid):
        return (os.path.join(self.dir, f"debug_sync_{tag}_{pid}.json"),
                os.path.join(self.dir, f"custody_{tag}_{pid}.json"))

    def body(self, body: str, tag: str) -> str:
        """``body`` (run after ``torch_procs.PRELUDE``, which binds
        ``pid``) with its reports named for ``tag`` and its process."""
        ds, cl = self._paths(tag, "%d")
        return ("import os as _os\n"
                f"_os.environ['BRPC_TPU_DEBUG_SYNC_REPORT'] = {ds!r} % pid\n"
                f"_os.environ['BRPC_TPU_CUSTODY_REPORT'] = {cl!r} % pid\n"
                + body)

    def check(self, tag: str, results: list) -> list:
        """Assert the reports of ``tag``'s children that exited 0;
        returns them, ``(debug_sync, custody)`` a child."""
        out = []
        for pid, (rc, _r, _text) in enumerate(results):
            if rc != 0:
                continue
            what = f"{tag} process {pid}"
            ds_path, cl_path = self._paths(tag, pid)
            assert os.path.exists(ds_path), \
                f"{what} exited 0 but wrote no debug_sync report"
            with open(ds_path) as f:
                rep = json.load(f)
            assert not rep["cycles"], (f"{what}: runtime lock-order cycle:\n"
                                       + json.dumps(rep["cycles"], indent=2))
            assert not rep["long_holds"], (
                f"{what}: long lock holds:\n"
                + json.dumps(rep["long_holds"], indent=2))
            assert rep["ok"] and rep["nodes"], rep
            assert os.path.exists(cl_path), \
                f"{what} exited 0 but wrote no custody ledger report"
            with open(cl_path) as f:
                crep = json.load(f)
            assert crep["enabled"], crep
            assert not crep["outstanding"], (
                f"{what}: custody holds leaked (acquiring site named per "
                f"hold):\n" + json.dumps(crep["outstanding"], indent=2))
            assert not crep["unmatched_releases"], (
                f"{what}: unmatched strict releases:\n"
                + json.dumps(crep["unmatched_releases"], indent=2))
            out.append((rep, crep))
        return out


@contextlib.contextmanager
def debug_layers():
    """Both runtime layers on for every child started inside (set in
    this process's environment, which the children inherit; put back
    after).  Yields the ``_Layers`` that names and checks the reports."""
    report_dir = tempfile.mkdtemp(prefix="torch_layers_")
    saved = {k: os.environ.get(k) for k in _LAYER_ENV}
    os.environ.update({
        "BRPC_TPU_DEBUG_LOCK_ORDER": "1",
        "BRPC_TPU_DEBUG_CUSTODY": "1",
        # present at the children's import, so each registers its dump;
        # layers.body() names each child's own file before it exits
        "BRPC_TPU_DEBUG_SYNC_REPORT": os.path.join(report_dir, "unnamed"),
        "BRPC_TPU_CUSTODY_REPORT": os.path.join(report_dir, "unnamed_c")})
    try:
        yield _Layers(report_dir)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(report_dir, ignore_errors=True)
