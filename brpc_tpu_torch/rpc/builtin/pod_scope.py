"""Pod-scope observability: builtin queries fanned out over pod membership.

Port of :mod:`brpc_tpu.rpc.builtin.pod_scope`.  A router→prefill→decode
request crosses three processes; each one's span store, /vars and
/brpc_metrics see only their own slice.  This module turns any pod member
into a whole-pod query point:

  * ``rpcz_pod`` — ``/rpcz?trace_id=``: query every up member's
    ``brpc_tpu.Trace.FindTrace`` (over the fabric: the channel to each
    member is an ordinary ``ici://`` channel through ``connect_any``), map
    every remote span's wall anchor onto the local clock with the fabric's
    per-pair offset estimate (:mod:`...ici.clock`, ±RTT/2 bound), and
    merge the spans into ONE causally ordered tree — parent links from
    span ids, sibling order from aligned timestamps.
  * ``vars_pod`` / ``metrics_pod`` — ``?scope=pod``: pull every member's
    exposed variables over ``brpc_tpu.Builtin.Call`` and emit them grouped
    per process (/vars) or as process-labelled Prometheus exposition
    (/brpc_metrics: ``name{process="2"} value``).

Members are addressed by their first serving, non-draining rank; the
local member answers locally (no self-RPC).  A member that cannot be
reached contributes an error entry, never a hang: the fan-out uses a 4 s
per-member timeout and no retries (an rpcz query must not retry its way
into a draining member)."""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

# one cached channel per member endpoint: fan-outs are repeated
# (dashboards poll) and a fresh fabric handshake per query would be the
# expensive path
_channels_lock = threading.Lock()
_channels: Dict[str, object] = {}

_FANOUT_TIMEOUT_MS = 4000


def _member_targets() -> Tuple[Optional[object], List[Tuple[int, Optional[str]]]]:
    """(pod, [(pid, endpoint-or-None)]) for every UP member; None
    endpoint = the local member (answered locally) or a member with no
    serving device (reported as unreachable)."""
    from ...ici.pod import Pod, UP
    pod = Pod.current()
    if pod is None:
        return None, []
    out: List[Tuple[int, Optional[str]]] = []
    for pid, m in sorted(pod.members(refresh=True).items()):
        if m.state != UP:
            continue
        if pid == pod.pid:
            out.append((pid, None))
            continue
        dev = next((d for d in m.serving if d not in m.draining), None)
        out.append((pid, f"ici://{dev}" if dev is not None else None))
    return pod, out


def _channel_to(target: str):
    with _channels_lock:
        ch = _channels.get(target)
    if ch is not None:
        return ch
    from ..channel import Channel, ChannelOptions
    ch = Channel()
    ch.init(target, options=ChannelOptions(
        timeout_ms=_FANOUT_TIMEOUT_MS, max_retry=0))
    with _channels_lock:
        kept = _channels.setdefault(target, ch)
    if kept is not ch:
        try:
            ch.close()
        except Exception:
            pass
    return kept


def _evict_channel(target: str) -> None:
    with _channels_lock:
        ch = _channels.pop(target, None)
    if ch is not None:
        try:
            ch.close()
        except Exception:
            pass


def _prune_channels(valid: set) -> None:
    """Drop cached channels for endpoints no longer in the member table
    (departed or restarted members must not pin sockets forever)."""
    with _channels_lock:
        stale = [t for t in _channels if t not in valid]
    for t in stale:
        _evict_channel(t)


def _call_member(target: str, method: str, fields: dict) -> dict:
    from ..controller import Controller
    from .rpc_service import JsonMsg
    ch = _channel_to(target)
    cntl = Controller()
    resp = ch.call_method(method, cntl, JsonMsg(**fields), JsonMsg)
    if cntl.failed():
        # a dead member is not re-dialed from the cache on every poll:
        # evict, so the next fan-out starts fresh
        _evict_channel(target)
        raise ConnectionError(
            f"{method} at {target}: {cntl.error_code_} {cntl.error_text_}")
    return resp.fields


def _fanout_members(jobs):
    """Run {pid: thunk} concurrently (one thread per remote member) and
    return {pid: ("ok", result) | ("err", text)}.  Pod membership keeps a
    crashed member's record up by design (liveness is the health
    checker's concern), so per-member timeouts must overlap: a serial
    fan-out would stall a trace query behind each dead member in turn."""
    results: Dict[int, tuple] = {}
    rlock = threading.Lock()

    def run(pid, thunk):
        try:
            r = ("ok", thunk())
        except Exception as e:
            r = ("err", f"{type(e).__name__}: {e}")
        with rlock:
            results[pid] = r

    threads = [threading.Thread(target=run, args=(pid, thunk),
                                name=f"pod_fanout:{pid}", daemon=True)
               for pid, thunk in jobs.items()]
    for t in threads:
        t.start()
    end = time.monotonic() + _FANOUT_TIMEOUT_MS / 1000.0 + 2.0
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    with rlock:
        for pid in jobs:
            results.setdefault(pid, ("err", "fan-out timed out"))
        return dict(results)


# ---- /rpcz?trace_id= pod stitching -------------------------------------

def rpcz_pod(server, q: dict):
    """The pod-scope /rpcz handler body: one trace stitched across every
    member, or every member's recent spans when no trace_id was given."""
    from ..span import find_trace, recent_spans, rpcz_enabled
    from ...ici import clock as _clock
    pod, targets = _member_targets()
    if pod is None:
        return "application/json", json.dumps(
            {"error": "scope=pod requires a joined pod (ici/pod.py)"},
            indent=1)
    tid_q = q.get("trace_id")
    # the local member IS pod.pid (the key _member_targets used)
    my_pid = pod.pid
    processes: Dict[str, dict] = {}
    spans: List[dict] = []
    _prune_channels({t for _, t in targets if t is not None})
    fields = ({"trace_id": tid_q} if tid_q
              else {"limit": int(q.get("limit", "100"))})
    method = ("brpc_tpu.Trace.FindTrace" if tid_q
              else "brpc_tpu.Trace.ListRecent")
    jobs = {}
    for pid, target in targets:
        if target is None and pid != my_pid:
            processes[str(pid)] = {"error": "no serving endpoint"}
            continue
        if pid == my_pid:
            continue                     # answered locally below
        jobs[pid] = (lambda t=target:
                     _call_member(t, method, fields)["spans"])
    results = _fanout_members(jobs)
    if tid_q:
        local = [s.describe() for s in find_trace(int(tid_q, 16))]
    else:
        local = [s.describe()
                 for s in recent_spans(int(q.get("limit", "100")))]
    results[my_pid] = ("ok", local)
    for pid in sorted(results):
        status, got = results[pid]
        if status != "ok":
            processes[str(pid)] = {"error": got}
            continue
        # clock alignment: map the member's wall anchors onto our wall
        # axis; bound -1 = no fabric sample for that peer (raw wall
        # clocks, skew unbounded, and the answer says so)
        for s in got:
            if pid == my_pid:
                aligned, bound = float(s["start_real_us"]), 0.0
            else:
                aligned, bound = _clock.to_local_wall_us(
                    pid, s["start_real_us"])
            s["process"] = pid
            s["aligned_start_us"] = int(aligned)
            s["clock_bound_us"] = bound
        processes[str(pid)] = {"spans": len(got)}
        spans.extend(got)
    out = {
        "enabled": rpcz_enabled(),
        "scope": "pod",
        "pod": pod.name,
        "queried_from": my_pid,
        "processes": processes,
        "clock": _clock.describe(),
        "span_count": len(spans),
    }
    if tid_q:
        out["trace_id"] = tid_q
        out["tree"] = stitch_tree(spans)
    else:
        out["spans"] = sorted(spans,
                              key=lambda s: s["aligned_start_us"])
    return "application/json", json.dumps(out, indent=1)


def stitch_tree(spans: List[dict]) -> List[dict]:
    """Merge span dicts (with aligned_start_us already set) into a
    causally ordered forest: children under their parent span, siblings
    and roots ordered by aligned start.  Parent links come from span ids
    (carried in RpcMeta and kind-4 descriptors); only sibling order relies
    on the clock alignment, and every node carries the bound that order
    is valid under."""
    by_id: Dict[str, dict] = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        by_id[node["span_id"]] = node
    roots: List[dict] = []
    for node in by_id.values():
        parent = by_id.get(node["parent"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def order(nodes: List[dict]) -> List[dict]:
        nodes.sort(key=lambda n: n["aligned_start_us"])
        for n in nodes:
            order(n["children"])
        return nodes
    return order(roots)


# ---- /vars and /brpc_metrics pod aggregation ---------------------------

def _fanout_page(server, page: str, query: dict) -> Dict[int, dict]:
    """{pid: {"body": str} | {"error": str}} for one builtin page pulled
    from every up member over brpc_tpu.Builtin.Call; the local member
    answers through ``server``'s own dispatcher (the one the RPC would
    reach), with no self-RPC."""
    pod, targets = _member_targets()
    if pod is None:
        return {}
    my_pid = pod.pid
    out: Dict[int, dict] = {}
    _prune_channels({t for _, t in targets if t is not None})

    def remote(target):
        got = _call_member(target, "brpc_tpu.Builtin.Call",
                           {"page": page, "query": query})
        if got.get("status", 200) != 200:
            raise RuntimeError(
                f"status {got.get('status')}: {got.get('body')}")
        return got["body"]

    jobs = {}
    for pid, target in targets:
        if pid == my_pid:
            continue                     # answered locally below
        if target is None:
            out[pid] = {"error": "no serving endpoint"}
            continue
        jobs[pid] = (lambda t=target: remote(t))
    results = _fanout_members(jobs)
    try:
        if getattr(server, "_builtin", None) is None:
            raise RuntimeError("no local server with builtins")
        hit = server._builtin.dispatch(page, query)
        results[my_pid] = ("ok", hit[-1])
    except Exception as e:
        results[my_pid] = ("err", f"{type(e).__name__}: {e}")
    for pid, (status, body) in results.items():
        out[pid] = {"body": body} if status == "ok" else {"error": body}
    return out


def vars_pod(server, q: dict):
    query = {"filter": q["filter"]} if q.get("filter") else {}
    results = _fanout_page(server, "vars", query)
    if not results:
        return "text/plain", "scope=pod requires a joined pod\n"
    lines: List[str] = []
    for pid in sorted(results):
        r = results[pid]
        lines.append(f"== process {pid} ==")
        if "error" in r:
            lines.append(f"<unreachable: {r['error']}>")
        else:
            lines.append(r["body"].rstrip("\n"))
    return "text/plain", "\n".join(lines) + "\n"


def metrics_pod(server, q: dict):
    """Process-labelled Prometheus exposition: every member's gauges
    with a ``process`` label (the MultiDimension labelling convention),
    TYPE lines deduplicated across members."""
    results = _fanout_page(server, "brpc_metrics", {})
    if not results:
        return "text/plain; version=0.0.4", \
            "# scope=pod requires a joined pod\n"
    lines: List[str] = []
    typed = set()
    errors: List[str] = []
    for pid in sorted(results):
        r = results[pid]
        if "error" in r:
            errors.append(f"# process {pid} unreachable: {r['error']}")
            continue
        for line in r["body"].splitlines():
            if not line:
                continue
            if line.startswith("#"):
                if line not in typed:
                    typed.add(line)
                    lines.append(line)
                continue
            name, _, value = line.rpartition(" ")
            if not name:
                continue
            lines.append(f'{name}{{process="{pid}"}} {value}')
    return ("text/plain; version=0.0.4",
            "\n".join(errors + lines) + "\n")


def close_channels_for_test() -> None:
    """Drop the fan-out channel cache (a test's teardown)."""
    with _channels_lock:
        chans = list(_channels.values())
        _channels.clear()
    for ch in chans:
        try:
            ch.close()
        except Exception:
            pass
