"""Phase 3's plane echo (and phase 8's serving) of two source trees, in
turns, on the card.

    python3 -m brpc_tpu_torch.tools.echo_ab PARENT_DIR CHANGE_DIR \
        [--pairs 3] [--serving]
    python3 -m brpc_tpu_torch.tools.echo_ab --serving --from-log LOG

Each tree is a checkout holding ``chip_smoke.py`` and ``brpc_tpu_torch/``
(for example a parent commit unpacked with ``git archive``).  For each pair
of turns the trees run in the order parent, change, change, parent, each in
a process of its own that builds ``p2p_copy`` from its own sources and runs
``chip_smoke.phase_plane_echo`` three times (300 calls of 4 KiB after 20
warm-ups each) and, with ``--serving``, ``chip_smoke.phase_serving`` once
(its Generate p50 and LoadKv p50).  Prints one JSON line per process, then
a summary: for each tree and metric the median, the quartiles and the
range, the pairs the change won and a rank-sum p.  Needs one card;
``--from-log`` summarizes a saved log anywhere.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_RUN = r"""
import json, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
import chip_smoke as cs
import brpc_tpu_torch
assert brpc_tpu_torch.__file__.startswith(tree), brpc_tpu_torch.__file__
import brpc_tpu_torch.policy
from brpc_tpu_torch import rpc
from brpc_tpu_torch.ici import device_plane
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.ici.p2p_copy import p2p_copy
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
p2p_copy.build()
mesh = IciMesh(ranks=8)
IciMesh.set_default(mesh)
plane = device_plane.plane()
outs = [cs.phase_plane_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                            EchoResponse) for _ in range(3)]
res = {"tree": tree, "p50_us_4k": [o["p50_us_4k"] for o in outs],
       "p99_us_4k": [o["p99_us_4k"] for o in outs]}
if sys.argv[2] == "1":
    p2p_copy.launches = 0          # the phase checks its launches alone
    serve = cs.phase_serving(mesh, plane, p2p_copy)
    res["generate_p50_ms"] = [serve["generate"]["p50_ms"]]
    res["loadkv_p50_us"] = [serve["roster"]["loadkv_p50_us"]]
print(json.dumps(res))
"""


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def summarize(rows, metrics) -> dict:
    """Per tree and metric: median, quartiles, range and run count; per
    metric: the pairs (each parent, change, change, parent turn) whose
    change median is lower, and the two-sided rank-sum p of change
    against parent over all runs."""
    got = {side: {m: [] for m in metrics} for side in ("parent", "change")}
    won = {m: 0 for m in metrics}
    for k in range(0, len(rows) - 3, 4):
        turn = {side: {m: [] for m in metrics} for side in got}
        for r in rows[k:k + 4]:
            for m in metrics:
                turn[r["side"]][m].extend(r[m])
                got[r["side"]][m].extend(r[m])
        for m in metrics:
            won[m] += (statistics.median(turn["change"][m])
                       < statistics.median(turn["parent"][m]))
    out = {side: {m: {"median": statistics.median(v),
                      "quartiles": _quartiles(v),
                      "range": (min(v), max(v)), "runs": len(v)}
                  for m, v in by_metric.items()}
           for side, by_metric in got.items()}
    from scipy.stats import mannwhitneyu
    out["pairs"] = len(rows) // 4
    out["pairs_won_by_change"] = won
    out["rank_sum_p"] = {m: float(mannwhitneyu(got["change"][m],
                                               got["parent"][m]).pvalue)
                         for m in metrics}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--serving", action="store_true")
    ap.add_argument("--from-log", help="summarize a log this tool printed "
                    "instead of running the trees")
    args = ap.parse_args(argv)
    metrics = ["p50_us_4k"] + (["generate_p50_ms", "loadkv_p50_us"]
                               if args.serving else [])
    if args.from_log:
        with open(args.from_log) as f:
            rows = [json.loads(line) for line in f
                    if line.startswith('{"side"')]
        print(json.dumps({"summary": summarize(rows, metrics)}))
        return 0
    if not (args.parent and args.change):
        ap.error("PARENT_DIR and CHANGE_DIR are required")
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    rows = []
    for _ in range(args.pairs):
        for side in ("parent", "change", "change", "parent"):
            proc = subprocess.run(
                [sys.executable, "-c", _RUN, trees[side],
                 "1" if args.serving else "0"],
                cwd=trees[side], capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            rows.append({"side": side, **out})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"summary": summarize(rows, metrics)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
