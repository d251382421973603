"""The builtin admin pages (reference: src/brpc/builtin/*.{h,cpp}: /status
/vars /flags /connections /health /rpcz /protobufs /brpc_metrics ...),
ported from :mod:`brpc_tpu.rpc.builtin.services`.

Every page is served as an RPC method (``brpc_tpu.Builtin.Call``,
:mod:`.rpc_service`) over any transport the port speaks, ``ici://``
included, so an admin can read a rank's runtime through the mesh.  Pages
return JSON, or text in the Prometheus format for /vars and
/brpc_metrics; the profiler's (``hotspots``, ``contention``, ``pprof/*``)
are among them.  On a joined pod member ``vars?scope=pod``,
``rpcz?trace_id=`` (or ``?scope=pod``) and ``brpc_metrics?scope=pod``
answer for the whole pod (:mod:`.pod_scope`); ``?scope=local`` keeps a
trace query to this process.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

from ... import bvar
from ...butil import flags as _flags


class BuiltinDispatcher:
    """path → handler(server, query: dict) -> (content_type, body), or
    (http_status, content_type, body) for pages whose status carries the
    signal (/health while draining → 503)."""

    def __init__(self, server):
        self.server = server
        self.handlers: Dict[str, Callable] = {}
        self._register_defaults()

    def add(self, path: str, fn: Callable) -> None:
        self.handlers[path.strip("/")] = fn

    def dispatch(self, path: str, query: Optional[dict] = None):
        fn = self.handlers.get(path.strip("/"))
        if fn is None:
            return None
        try:
            return fn(self.server, query or {})
        except Exception as e:
            # a handler's exception is a response, never a hung client
            return "text/plain", f"error: {type(e).__name__}: {e}\n"

    def paths(self):
        return sorted(self.handlers)

    def _register_defaults(self) -> None:
        for path, fn in (("health", _health), ("status", _status),
                         ("vars", _vars), ("flags", _flags_page),
                         ("connections", _connections), ("rpcz", _rpcz),
                         ("brpc_metrics", _metrics),
                         ("protobufs", _protobufs), ("sockets", _sockets),
                         ("bthreads", _bthreads), ("ids", _ids),
                         ("index", _index), ("version", _version),
                         ("threads", _threads),
                         ("list_services", _list_services), ("ici", _ici),
                         ("vlog", _vlog), ("dir", _dir),
                         ("hotspots", _hotspots),
                         ("contention", _contention),
                         ("pprof/cmdline", _pprof_cmdline),
                         ("pprof/profile", _pprof_profile),
                         ("pprof/symbol", _pprof_symbol)):
            self.add(path, fn)


def _health(server, q):
    # a draining server stops reporting healthy before its hard stop
    if server.is_draining():
        return 503, "text/plain", "draining"
    return "text/plain", "OK"


def _lifecycle(server) -> str:
    if server.is_draining():
        return "draining"
    return "running" if server.is_running() else "stopped"


def _version(server, q):
    from ... import __version__
    return "text/plain", f"brpc_tpu_torch/{__version__}"


def _status(server, q):
    bvar.expose_default_variables()
    out = {
        "server": str(server.listen_endpoint),
        "name": server.options.server_info_name or "",
        "state": _lifecycle(server),
        "inflight_requests": server.inflight_requests(),
        "uptime_s": round(time.time() - _start_time, 1),
        "services": sorted(server.services()),
        "methods": [ms.describe() for ms in server.method_statuses()],
        "connections": len(server.connections()),
    }
    if server.admission is not None:
        out["admission"] = server.admission.describe()
    pool = server.usercode_pool
    if pool is not None and hasattr(pool, "describe"):
        out["usercode_pool"] = pool.describe()
    serving = {}
    for name, svc in server.services().items():
        fn = getattr(svc, "describe_serving", None)
        if callable(fn):
            try:
                serving[name] = fn()
            except Exception:
                pass
    if serving:
        out["serving"] = serving
    return "application/json", json.dumps(out, indent=1)


def _vars(server, q):
    if q.get("scope") == "pod":
        # every member's exposed variables over brpc_tpu.Builtin.Call,
        # grouped per process
        from .pod_scope import vars_pod
        return vars_pod(server, q)
    bvar.expose_default_variables()
    wildcard = q.get("filter", "")
    lines = [f"{name} : {value}"
             for name, value in bvar.dump_exposed(wildcard)]
    return "text/plain", "\n".join(lines) + "\n"


def _flags_page(server, q):
    setname = q.get("setvalue")
    if setname:
        try:
            _flags.set_flag(setname, q.get("to", ""))
            return "text/plain", f"set {setname} ok"
        except Exception as e:
            return "text/plain", f"error: {e}"
    lines = [f"{f.name}={f.get()}  (default={f.default})  {f.help}"
             for f in _flags.list_flags()]
    return "text/plain", "\n".join(lines) + "\n"


def _connections(server, q):
    rows = []
    for s in server.connections():
        rows.append({
            "remote": str(s.remote_side),
            "in_bytes": s.stat.in_size, "out_bytes": s.stat.out_size,
            "in_messages": s.stat.in_num_messages,
            "out_messages": s.stat.out_num_messages,
            "age_s": round(time.time() - s.create_time, 1),
        })
    return "application/json", json.dumps(rows, indent=1)


def _rpcz(server, q):
    from ..span import recent_spans, find_trace, rpcz_enabled
    tid = q.get("trace_id")
    scope = q.get("scope")
    if scope != "local" and (scope == "pod" or tid):
        # pod-scope stitching: a trace_id query on a joined member fans
        # out over the pod and answers with the merged tree; a process
        # with no pod falls through to its own spans
        from ...ici.pod import Pod
        if Pod.current() is not None or scope == "pod":
            from .pod_scope import rpcz_pod
            return rpcz_pod(server, q)
    if tid:
        spans = find_trace(int(tid, 16))
    else:
        spans = recent_spans(int(q.get("limit", "100")))
    return "application/json", json.dumps({
        "enabled": rpcz_enabled(),
        "spans": [s.describe() for s in spans],
    }, indent=1)


def _metrics(server, q):
    """The Prometheus exposition (prometheus_metrics_service.cpp)."""
    if q.get("scope") == "pod":
        # process-labelled exposition pulled from every pod member
        from .pod_scope import metrics_pod
        return metrics_pod(server, q)
    bvar.expose_default_variables()
    lines = []
    for name, value in bvar.dump_exposed():
        try:
            float(value)
        except (TypeError, ValueError):
            continue
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "text/plain; version=0.0.4", "\n".join(lines) + "\n"


def _protobufs(server, q):
    out = {}
    for full_name, md in server._methods.items():
        out[full_name] = {
            "request": md.request_cls.DESCRIPTOR.full_name
            if hasattr(md.request_cls, "DESCRIPTOR") else str(md.request_cls),
            "response": md.response_cls.DESCRIPTOR.full_name
            if hasattr(md.response_cls, "DESCRIPTOR")
            else str(md.response_cls),
        }
    return "application/json", json.dumps(out, indent=1)


def _sockets(server, q):
    from ..socket import list_sockets
    return "text/plain", "\n".join(s.description() for s in list_sockets())


def _bthreads(server, q):
    from ...bthread.scheduler import TaskControl
    ctl = TaskControl.instance()
    return "application/json", json.dumps({
        "workers": len(ctl.groups),
        "tasklets": ctl.pool.size(),
        "queue_depths": [len(g.deque) for g in ctl.groups],
        "blocked_workers": ctl._blocked_workers,
    })


def _ids(server, q):
    from ...bthread.id import _pool
    return "text/plain", f"live correlation ids: {_pool.size()}"


def _threads(server, q):
    """A stack dump of every live thread (builtin/threads_service.cpp)."""
    import sys
    import threading as _threading
    import traceback
    names = {t.ident: t.name for t in _threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} (tid={tid}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "text/plain", "\n".join(out) + "\n"


def _list_services(server, q):
    """The service and method registry (builtin/list_service.cpp)."""
    out = {}
    for name, svc in server.services().items():
        out[name] = [
            {"method": m, "request": md.request_cls.__name__
             if md.request_cls else "",
             "response": md.response_cls.__name__
             if md.response_cls else ""}
            for m, md in svc.methods().items()]
    return "application/json", json.dumps(out, indent=1)


def _ici(server, q):
    """The ici:// fabric's planes: transport byte totals, the device plane
    (counters and the last transfers' timelines), plane health and its
    event counters, the pod's membership, the multi-process fabric (per
    peer process, and per socket its device plane's health, sequencer and
    IPC cache; the route counters) and the compiled collective
    fan-out."""
    from ...ici import fabric as _fabric
    from ...ici.transport import ici_transport_stats
    from ...ici.device_plane import DevicePlane
    from ...ici.route import collective_stats, plane_stats, route_stats
    from ...channels import collective_fanout as _cf
    moved, device_moved = ici_transport_stats()
    out = {"transport": {"bytes_moved": moved,
                         "device_bytes_moved": device_moved}}
    plane = DevicePlane._instance
    out["device_plane"] = plane.stats() if plane is not None else {}
    out["device_plane_recent"] = (plane.recent_transfers()
                                  if plane is not None else [])
    from ...ici.pod import Pod
    pod = Pod.current()
    if pod is not None:
        out["pod"] = pod.describe()
    fab = _fabric.describe()
    if fab is not None:
        out["fabric"] = fab
        out["pair_planes"] = {str(pid): st for pid, st in
                              fab["pairs"].items()}
        seqs = {s["remote"]: s["sequencer"] for s in fab["sockets"]
                if s["sequencer"] is not None}
        if seqs:
            out["dplane_sequencers"] = seqs
        out["routes"] = route_stats()
    cs = collective_stats()
    if cs:
        out["collective_route_events"] = cs
    planes = {}
    inst = _cf.CollectiveFanoutPlane._instance
    if inst is not None:
        planes["collective"] = inst._health.snapshot()
    ev = plane_stats()
    if ev:
        planes["events"] = ev
    if planes:
        out["planes"] = planes
    if _cf.registry().method_names() or inst is not None:
        out["collective_fanout"] = _cf.describe()
    return "application/json", json.dumps(out, indent=1)


def _hotspots(server, q):
    """CPU profile for ?seconds=N, at most 30 (the gperftools/pprof
    stand-in of hotspots_service.cpp)."""
    from ..profiler import profile_for
    seconds = min(float(q.get("seconds", "1")), 30.0)
    return "text/plain", profile_for(seconds, top=int(q.get("top", "40")))


def _contention(server, q):
    """The lock contention profile; ?enable=1 / ?enable=0 switch it."""
    from ..profiler import (contention_enabled, contention_profile,
                            enable_contention_profiler)
    if q.get("enable") == "1":
        enable_contention_profiler(True)
        return "text/plain", "contention profiler enabled"
    if q.get("enable") == "0":
        enable_contention_profiler(False)
        return "text/plain", "contention profiler disabled"
    lines = [f"enabled: {contention_enabled()}",
             f"{'total_wait_s':>12}  {'samples':>8}  site"]
    for site, n, total in contention_profile()[:50]:
        lines.append(f"{total:12.4f}  {n:8d}  {site}")
    return "text/plain", "\n".join(lines) + "\n"


def _pprof_cmdline(server, q):
    """pprof's remote protocol: the profiled program's command line
    (builtin/pprof_service.cpp)."""
    import sys
    return "text/plain", "\x00".join([sys.executable] + sys.argv)


def _pprof_profile(server, q):
    """pprof's remote protocol: a CPU profile for ?seconds=N, from the
    /hotspots engine."""
    return _hotspots(server, {"seconds": q.get("seconds", "2"),
                              "top": q.get("top", "60")})


def _pprof_symbol(server, q):
    """pprof's symbol endpoint: Python frames are symbolic already; the
    answer to pprof's probe."""
    return "text/plain", "num_symbols: 1\n"


def _vlog(server, q):
    """Verbose-logging control (builtin/vlog_service.cpp): the logger's
    minimum level."""
    import logging as _pylog
    from ...butil import logging as log
    if "level" in q:
        level = _pylog.getLevelNamesMapping().get(q["level"].upper())
        if level is None:
            return "text/plain", f"unknown level {q['level']!r}\n"
        log._logger.setLevel(level)
        return "text/plain", f"min level set to {q['level']}\n"
    return "text/plain", (
        f"min level: {_pylog.getLevelName(log._logger.level)}\n")


def _dir(server, q):
    """A file browser (builtin/dir_service.cpp) kept inside the server's
    working directory."""
    import os
    root = os.path.realpath(os.getcwd())
    rel = q.get("path", ".")
    path = os.path.realpath(os.path.join(root, rel))
    if os.path.commonpath([root, path]) != root:
        return "text/plain", "path escapes working directory\n"
    try:
        if os.path.isdir(path):
            entries = sorted(os.listdir(path))
            return "application/json", json.dumps(
                {"dir": os.path.relpath(path, root), "entries": entries})
        with open(path, "rb") as f:
            data = f.read(1 << 20)
        return "text/plain", data.decode("utf-8", "replace")
    except OSError as e:
        return "text/plain", f"cannot read: {e}\n"


def _index(server, q):
    builtin = getattr(server, "_builtin", None)
    return "application/json", json.dumps({
        "paths": builtin.paths() if builtin is not None else [],
    })


_start_time = time.time()


def register_builtin_services(server) -> None:
    """Give ``server`` its dispatcher and mount the two admin RPC services
    (before the server marks itself started)."""
    server._builtin = BuiltinDispatcher(server)
    from .rpc_service import BuiltinRpcService, TraceService
    if TraceService.SERVICE_NAME not in server.services():
        server.add_service(TraceService())
    if BuiltinRpcService.SERVICE_NAME not in server.services():
        server.add_service(BuiltinRpcService())
