"""The port's named locks and ledger hooks against the JAX package's.

``butil/debug_sync.py``'s graph is keyed by lock NAME, so the port names
each lock it creates through ``make_lock`` / ``make_rlock`` as the JAX
package names its counterpart.  Both sets are read from the packages'
source text.  The port's set is the JAX set less ``NO_COUNTERPART``,
each entry with its reason; the port names no lock the JAX package does
not.  The custody ledger's resource names are the same on both, hook for
hook.
"""
from __future__ import annotations

import collections
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOCK = re.compile(r"\bmake_r?lock\(\s*f?\"([^\"]+)\"")
_HOOK = re.compile(
    r"\b_ledger\.(acquire|release|drop_prefix)\(\s*\"([^\"]+)\"")

# JAX lock names the port has no site for, and why
NO_COUNTERPART = {
    "FabricNode._xfer_lock":
        "guards FabricNode._xfer_conns, the JAX node's cache of "
        "transfer-server connections; the port's kind 1 pulls through "
        "ici/ipc_pull.py and dials no transfer server",
    "CollectiveFanoutPlane._lock":
        "guards the JAX fan-out plane's compiled-program cache "
        "(_programs, _building); the port runs the fan-out's bodies "
        "eagerly and has no cache (ROADMAP queue 5)",
    "TaskControl._count_lock":
        "guards TaskControl.tasklet_count; the port's scheduler keeps no "
        "tasklet count",
}


def _scan(pkg: str, pattern) -> list:
    out = []
    root = os.path.join(REPO, pkg)
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if rel in ("butil/debug_sync.py", "tools/fablint.py"):
                continue
            with open(path) as fh:
                out += [(rel, m.groups()) for m in
                        pattern.finditer(fh.read())]
    return out


def test_port_lock_names_are_the_reference_names_less_the_listed():
    jax = {g[0] for _, g in _scan("brpc_tpu", _LOCK)}
    port = {g[0] for _, g in _scan("brpc_tpu_torch", _LOCK)}
    assert len(jax) >= 50, sorted(jax)
    assert set(NO_COUNTERPART) <= jax, set(NO_COUNTERPART) - jax
    assert all(len(why) > 20 for why in NO_COUNTERPART.values())
    assert port == jax - set(NO_COUNTERPART), (
        sorted(port - jax), sorted(jax - set(NO_COUNTERPART) - port))


def test_each_lock_name_lives_in_the_same_module():
    jax = {g[0]: rel for rel, g in _scan("brpc_tpu", _LOCK)}
    port = {g[0]: rel for rel, g in _scan("brpc_tpu_torch", _LOCK)}
    assert {n: port[n] for n in port} == {n: jax[n] for n in port}


def test_ledger_resources_and_hooks_match():
    def hooks(pkg):
        return collections.Counter(
            (rel, kind, res) for rel, (kind, res) in _scan(pkg, _HOOK))
    jax, port = hooks("brpc_tpu"), hooks("brpc_tpu_torch")
    assert {r for _, _, r in jax} == {"dev.transfer", "cntl", "stream",
                                      "kv.reserve", "kv.pin"}
    assert port == jax, (port - jax, jax - port)
    assert sum(port.values()) == 20
