"""``chip_smoke.py`` phase 26 (rpc_press plain, fan-out and serving,
rpc_view, parallel_http, this slice's examples) rehearsed on the CPU at a
small size, in the fresh interpreter the phase runs in on the card, its
own checks held: a CPU mesh with the device plane engaged on it,
``p2p_copy``'s plain version counted in place of its launches, 0.5-1 s
legs and 16 URLs."""
from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase26_rehearsal_on_cpu():
    sys.path.insert(0, _REPO)
    import chip_smoke as cs
    r = cs.phase_tools_examples_proc(
        device="cpu", PRESS_S=0.5, PRESS_FANOUT_S=0.5, PRESS_SERVING_S=1.0,
        PRESS_QPS=200, PRESS_FANOUT_SHARD=4096, PARALLEL_HTTP_URLS=16)
    assert r["foreign"] == [] and r["kernel_launches"] == {
        "p2p_copy": 0, "ring_all_reduce": 0, "ring_all_gather": 0}
    assert r["sockets_left"] == 0 and r["default_device"] == "cpu"
    a, b, c, d, e = r["a"], r["b"], r["c"], r["d"], r["e"]
    for leg in ("ici", "mem", "tcp"):
        assert a[leg]["sent"] > 0 and a[leg]["phase_p50_us"] > 0
    assert a["throttled"]["qps"] <= 200 * 1.05
    assert b["per_route"] == {"collective": b["sent"]} and b["errors"] == 0
    # the plain copies counted in place of launches
    assert c["launches"] == c["transfers"] == c["loadkv_received"] > 0
    assert {"serving_status", "kv_prefix", "kv_tiers"} <= set(c)
    assert d["http"]["ok"] == 16 and len(d["view"]) == 6
    assert sorted(e) == sorted(cs.EXAMPLES_26)
    assert all(v["rc"] == 0 for v in e.values())
    assert e["ici_echo"]["launches"] == e["ici_echo"]["transfers"] == 60
    assert r["launches"] == r["transfers"]
    assert cs.phase26_summary(r).startswith("tools/examples: rpc_press ")


def test_no_phase_rebinds_another_phases_name():
    """Every module-level name of ``chip_smoke.py`` is bound once: a
    phase's constant that reuses an earlier phase's name changes the
    earlier phase too (phase 26's fan-out shard once turned phase 13's 512
    B shard into 64 KiB, and phase 23's 2 s GOAWAY grace had replaced
    phase 10's 5 s drain grace)."""
    import ast
    import collections
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    bound = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            bound[node.name] += 1
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        bound[n.id] += 1
    assert [name for name, n in bound.items() if n > 1] == []
