"""A member process of a pod: joins the fabric and the pod, serves a role.

    python -m brpc_tpu_torch.tools.pod_peer HOST:PORT PID NPROC SCENARIO \\
        [--device cuda|cpu] [--seq 512 --steps 64 --prompts 20 --warmup 2]
        [--attach 65536]

Every process uses the same mesh of 8 ranks (``2·NPROC`` past four
processes) and owns ranks ``2·PID`` and ``2·PID + 1``
(``FabricNode.initialize(..., ranks=...)``); process 0 hosts the fabric's
store at ``HOST:PORT``.  Each joins one pod and serves
on ``ici://2·PID`` (the Python plane).  The processes coordinate through
the store and each prints its result as its last line, ``RESULT
{json}``.  Two scenarios:

  * ``generate`` (3 processes, pod ``pd``): the disaggregated Generate of
    the JAX package's ``bench_pod_prefill_decode``.  Process 0 serves the
    router (``Router.Generate``) and drives it; process 1 the prefill
    (rank 2), whose KV block crosses to process 2's decode (rank 4) as a
    kind-4 DEVICE payload the decode pulls on ``p2p_copy``.  (a) ``--warmup``
    then ``--prompts`` Generates of ``--seq`` tokens x ``--steps`` steps
    from 2 client threads, each equal to ``reference_generate``; (b) rpcz
    turned on in the three processes over ``brpc_tpu.Builtin.Call``, one
    Generate, and one ``/rpcz?trace_id=`` on process 0 stitched into one
    tree; ``/vars`` and ``/brpc_metrics`` with ``scope=pod``; (c) the
    decode's drain and restart, seen through ``pod://pd``, then one more
    Generate.
  * ``chaos`` (NPROC >= 4, pod ``chaos``): the JAX package's pod
    membership contract (``tests/test_pod.py``'s N=4 chaos) with an
    ``--attach``-byte DEVICE attachment on every call, echoed back: every
    process calls through an ``rr`` channel on ``pod://chaos``; process
    2's serving endpoint is killed (no drain, no withdraw) and revived,
    process 3 drains and restarts, and the other processes' calls keep
    succeeding throughout; every process then reads the same final epoch.

Each process counts its copy launches (``p2p_copy``'s counter, or with
``--device cpu`` the calls of its plain version) from just before its
traffic, beside the device plane's transfers; it exits when the process
that started it dies.  ``chip_smoke.py`` phase 18 and
``tests/test_torch_pod.py`` start three or four of them in parallel.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import sys
import threading
import time
from datetime import timedelta

import torch

from .fabric_peer import _exit_with_parent

SOCKET_WINDOW = 64 << 20
BARRIER_S = 120.0
# the fanout scenario: a 64 MiB replicated operand rides one kind-4
# transfer per sub-call on its degraded leg, so the window holds it whole
FANOUT_WINDOW = 256 << 20
FANOUT_VICTIM = 1           # the member SIGKILLed mid-fan-out
FANOUT_RESTART_PID = 2      # the member that restarts ici://4
FANOUT_CRASH_RPC_MS = 3000  # the sub-call deadline of the SIGKILL leg


class _Member:
    """One pod member's fabric, store client and counters."""

    def __init__(self, args):
        import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
        from brpc_tpu_torch.butil import flags
        from brpc_tpu_torch.ici import device_plane, fabric
        from brpc_tpu_torch.ici.mesh import IciMesh
        self.args = args
        self.pid, self.n = args.pid, args.nproc
        self.rank = 2 * self.pid
        self.copy_mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
        self._plain = [0]
        if args.device == "cpu":
            inner = self.copy_mod.p2p_copy_plain

            def counted(src, dst):
                self._plain[0] += 1
                return inner(src, dst)

            self.copy_mod.p2p_copy_plain = counted
            flags.set_flag("ici_device_plane_host_mesh", True)
        # two ranks a member: 8, or more for a pod of over four
        self.mesh = IciMesh(ranks=max(8, 2 * self.n), device=args.device)
        IciMesh.set_default(self.mesh)
        flags.set_flag("ici_socket_window_bytes", SOCKET_WINDOW)
        self.fabric = fabric
        self.node = fabric.FabricNode.initialize(
            args.coord, self.n, self.pid, ranks=[self.rank, self.rank + 1],
            mesh=self.mesh)
        self.kv = self.client()
        self.plane = device_plane.plane()
        self._base = self.counts()

    def client(self):
        """A store client for the members' own coordination, never the
        node's (a blocking wait there would stall the node's handshakes).
        A client serves one blocking wait at a time: a thread that waits
        takes a client of its own."""
        from torch.distributed import TCPStore
        host, _, port = self.args.coord.rpartition(":")
        return TCPStore(host, int(port), is_master=False,
                        timeout=timedelta(seconds=BARRIER_S))

    def leave_store(self, skip=()) -> None:
        """The store lives in process 0, which stays up until every other
        member (but those in ``skip``, killed by the scenario) has made
        its last store call, ``Pod.leave``'s record: a member's late write
        to a store whose host exited fails."""
        if self.pid != 0:
            self.put(f"left/{self.pid}", 1)
            return
        for q in range(1, self.n):
            if q not in skip:
                self.get(f"left/{q}")

    def sync(self) -> None:
        if self.args.device == "cuda":
            torch.cuda.synchronize()

    def launches(self) -> int:
        return self._plain[0] if self.args.device == "cpu" \
            else self.copy_mod.p2p_copy.launches

    def counts(self) -> dict:
        p = self.plane
        return {"launches": self.launches(), "transfers": p.transfers,
                "remote_received": p.remote_received,
                "remote_sent": p.remote_sent}

    def zero(self) -> None:
        self.sync()
        self._base = self.counts()

    def deltas(self) -> dict:
        """Counts since :meth:`zero`; ``copies`` are the transfers whose
        copy ran in this process (in process, or pulled from a peer)."""
        self.sync()
        now = self.counts()
        d = {k: now[k] - self._base[k] for k in now}
        d["copies"] = d["transfers"] - d["remote_sent"]
        return d

    def key(self, name: str) -> str:
        return f"pod_peer/{self.args.scenario}/{name}"

    def put(self, name: str, value, kv=None) -> None:
        (kv or self.kv).set(self.key(name), json.dumps(value))

    def get(self, name: str, timeout: float = BARRIER_S, kv=None):
        kv = kv or self.kv
        kv.wait([self.key(name)], timedelta(seconds=timeout))
        return json.loads(kv.get(self.key(name)))

    def barrier(self, name: str, timeout: float = BARRIER_S) -> None:
        self.kv.set(self.key(f"{name}/{self.pid}"), "1")
        self.kv.wait([self.key(f"{name}/{q}") for q in range(self.n)],
                     timedelta(seconds=timeout))

    def fabric_sockets(self, live: bool = True):
        from brpc_tpu_torch.rpc.socket import list_sockets
        return [s for s in list_sockets()
                if isinstance(s, self.fabric.FabricSocket)
                and (not live or not s.failed)]

    def ipc(self) -> dict:
        socks = self.fabric_sockets(live=False)
        return {k: sum(s.ipc_stats()[k] for s in socks)
                for k in ("opens", "hits", "mapped")}

    def leaks(self) -> dict:
        """What a member leaves behind once its servers and channels are
        closed: active transfers, IPC mappings, shared-memory segments."""
        from brpc_tpu_torch.ici import ipc_pull
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and (
                self.plane.active_transfers() or self.ipc()["mapped"]
                or ipc_pull.live_segments()):
            time.sleep(0.05)
        return {"active": self.plane.active_transfers(),
                "mapped": self.ipc()["mapped"],
                "segments": len(ipc_pull.live_segments())}


def _foreign() -> list:
    # the port stands alone: no JAX, nothing of brpc_tpu
    return sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                  or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))


def _pod_list(name: str) -> list:
    from brpc_tpu_torch.policy.naming import create_naming_service
    return [str(e.endpoint)
            for e in create_naming_service(f"pod://{name}").get_servers()]


# ---- generate ----------------------------------------------------------

_WANT_SPANS = {
    (0, "client", "Router.Generate"), (0, "server", "Router.Generate"),
    (0, "client", "Prefill.Prefill"), (1, "server", "Prefill.Prefill"),
    (1, "client", "Decode.LoadKv"), (2, "server", "Decode.LoadKv"),
    (0, "client", "Decode.Decode"), (2, "server", "Decode.Decode"),
}


def _flatten(nodes):
    for n in nodes:
        yield n
        yield from _flatten(n["children"])


def _check_tree(stitched: dict) -> dict:
    """The JAX package's stitched-trace checks (``tests/
    test_observability.py``'s disaggregated trace): the eight RPC spans,
    the transfer pair under the LoadKv client span, one client root, and
    every child starting no earlier than its parent less the summed clock
    bounds.  Returns the failures (empty when it holds)."""
    bad = []
    flat = list(_flatten(stitched.get("tree") or []))
    got = {(n["process"], n["side"], n["method"]) for n in flat
           if n["side"] != "transfer"}
    if not _WANT_SPANS <= got:
        bad.append(f"missing spans {sorted(_WANT_SPANS - got)}")
    xfers = [n for n in flat if n["side"] == "transfer"]
    if {n["process"] for n in xfers} != {1, 2}:
        bad.append(f"transfer spans in processes "
                   f"{sorted(n['process'] for n in xfers)}")
    ann = {n["process"]: " | ".join(a for _, a in n["annotations"])
           for n in xfers}
    if not all(w in ann.get(1, "") for w in ("posted", "seq", "complete",
                                             "pin_held_us=")):
        bad.append(f"sender's transfer annotations: {ann.get(1)}")
    if not all(w in ann.get(2, "") for w in ("seq", "complete")):
        bad.append(f"receiver's transfer annotations: {ann.get(2)}")
    loadkv = [n for n in flat if (n["process"], n["side"], n["method"])
              == (1, "client", "Decode.LoadKv")]
    if loadkv and any(n["parent"] != loadkv[0]["span_id"] for n in xfers):
        bad.append("a transfer span is not under the LoadKv client span")

    def order(node):
        nb = max(node["clock_bound_us"], 0)
        for c in node["children"]:
            slack = nb + max(c["clock_bound_us"], 0) + 5
            if c["aligned_start_us"] < node["aligned_start_us"] - slack:
                bad.append(f"{c['method']} starts "
                           f"{node['aligned_start_us'] - c['aligned_start_us']}"
                           f" us before its parent {node['method']} "
                           f"(slack {slack})")
            order(c)

    roots = stitched.get("tree") or []
    if len(roots) != 1 or roots[0]["side"] != "client":
        bad.append(f"{len(roots)} roots")
    for r in roots:
        order(r)
    if stitched.get("span_count", 0) < 10:
        bad.append(f"span_count {stitched.get('span_count')}")
    return bad


def run_generate(m: _Member) -> dict:
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.examples.disagg_serving.model import (
        kv_nbytes, reference_generate)
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        DecodeService, PrefillService, RouterService)
    from brpc_tpu_torch.ici.pod import Pod
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    pod = Pod.join("pd")
    opts = rpc.ServerOptions(native_ici=False)
    if m.pid == 1:
        svc = PrefillService(2, m.mesh)
    elif m.pid == 2:
        svc = DecodeService(4, m.mesh)
    else:
        svc = RouterService("ici://2", ["ici://4"])

    def serve():
        s = rpc.Server(opts)
        s.add_service(svc)
        assert s.start(f"ici://{m.rank}") == 0
        return s

    server = serve()
    pod.wait_epoch(2 * m.n, timeout=60)
    out = {"pid": m.pid, "os_pid": os.getpid(),
           "pod_list": _pod_list("pd")}
    m.barrier("up")
    m.zero()
    if m.pid == 0:
        out.update(_drive_generate(m, pod, server, kv_nbytes,
                                   reference_generate, rpc, EchoRequest,
                                   EchoResponse))
    else:
        m.barrier("warm", 600)
        if m.pid == 1:
            warm = (svc.handoff_bytes, svc.handoff_ns)
        m.get("clients_done", 600)
        # (a)'s counts, read once the clients are done
        d = m.deltas()
        rep = {"launches": d["launches"], "copies": d["copies"],
               "received": d["remote_received"], "ipc": m.ipc()}
        if m.pid == 1:
            # the timed prompts' handoffs: the warm-ups' first crossings
            # (the decode's IPC opens) left out
            rep.update(handoff_bytes=svc.handoff_bytes,
                       timed_bytes=svc.handoff_bytes - warm[0],
                       timed_ns=svc.handoff_ns - warm[1])
        else:
            rep.update(attachments=svc.loadkv_received)
        m.put(f"a/{m.pid}", rep)
        out["a"] = rep
        if m.pid == 2:
            # (c) the decode's drain and restart
            grace = m.get("drain")
            t0 = time.monotonic()
            server.stop(grace)
            out["drain_s"] = time.monotonic() - t0
            server = serve()
            m.put("restarted", time.time())
    # three joins and advertises, then the decode's drain mark, withdraw
    # and re-advertise
    pod.wait_epoch(2 * m.n + 3, timeout=60)
    m.barrier("final")
    out["epoch"] = pod.epoch(refresh=True)
    m.barrier("exit", 600)
    svc.close()
    server.stop()
    pod.leave()
    m.leave_store()
    from brpc_tpu_torch.rpc.builtin import pod_scope
    pod_scope.close_channels_for_test()
    out["leaks"] = m.leaks()
    out["foreign"] = _foreign()
    return out


def _drive_generate(m, pod, server, kv_nbytes, reference_generate, rpc,
                    EchoRequest, EchoResponse) -> dict:
    a = m.args
    dev = m.mesh.device(0)
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=120000,
                                                  max_retry=0))
    errs = []
    refs = {}

    def generate(i, check=True):
        tokens = [(11 * i + j) % 997 for j in range(a.seq)]
        cntl = rpc.Controller()
        resp = ch.call_method("Router.Generate", cntl, EchoRequest(
            message=json.dumps({"tokens": tokens, "steps": a.steps})),
            EchoResponse)
        if cntl.failed():
            errs.append((i, cntl.error_code_, cntl.error_text))
            return cntl
        got = json.loads(resp.message)["tokens"]
        if check:
            want = refs.get(i)
            if want is None:
                want = refs[i] = reference_generate(tokens, a.steps, dev)
            if got != want:
                errs.append((i, "tokens differ from reference_generate"))
        return cntl

    out = {}
    # (a) warm-ups, then the timed prompts from two client threads
    for i in range(a.warmup):
        generate(1000 + i)
    m.barrier("warm", 600)
    # the references outside the timed window
    for i in range(a.prompts):
        refs[i] = reference_generate(
            [(11 * i + j) % 997 for j in range(a.seq)], a.steps, dev)
    half = a.prompts // 2
    threads = [threading.Thread(target=lambda lo=lo, hi=hi: [
        generate(i) for i in range(lo, hi)])
        for lo, hi in ((0, half), (half, a.prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    m.put("clients_done", 1)
    peers = {q: m.get(f"a/{q}") for q in (1, 2)}
    mine = m.deltas()
    hand = peers[1]
    n_gen = a.warmup + a.prompts
    out["a"] = {
        "generates": n_gen, "errors": list(errs),
        "seconds": dt, "tokens_per_s": a.prompts * a.steps / dt,
        "handoff_bytes": hand["handoff_bytes"],
        "handoff_expected": n_gen * kv_nbytes(a.seq),
        # bytes over the timed prompts' LoadKv round trips at the prefill
        "handoff_gbps": hand["timed_bytes"] / max(hand["timed_ns"], 1),
        "kv_block_bytes": kv_nbytes(a.seq),
        "router": {"launches": mine["launches"], "copies": mine["copies"]},
        "prefill": peers[1], "decode": peers[2]}
    # (b) rpcz on in every member (the flags page over Builtin.Call), one
    # Generate, its trace stitched from here
    from brpc_tpu_torch.rpc.builtin.rpc_service import JsonMsg
    for target in ("ici://0", "ici://2", "ici://4"):
        bch = rpc.Channel()
        bch.init(target, options=rpc.ChannelOptions(timeout_ms=10000))
        cntl = rpc.Controller()
        resp = bch.call_method(
            "brpc_tpu.Builtin.Call", cntl,
            JsonMsg(page="flags", query={"setvalue": "rpcz_enabled",
                                         "to": "true"}), JsonMsg)
        if cntl.failed() or "ok" not in resp.fields.get("body", ""):
            errs.append(("rpcz on", target, cntl.error_text))
        bch.close()
    cntl = generate(2000)
    tid = cntl.trace_id
    stitched, bad = {}, ["no trace id"]
    deadline = time.monotonic() + 30
    while tid and time.monotonic() < deadline:
        _, body = server._builtin.dispatch("rpcz",
                                           {"trace_id": "%x" % tid})
        stitched = json.loads(body)
        bad = _check_tree(stitched)
        if not bad:
            break
        time.sleep(0.2)
    _, vbody = server._builtin.dispatch("vars", {"scope": "pod"})
    _, mbody = server._builtin.dispatch("brpc_metrics", {"scope": "pod"})
    flat = list(_flatten(stitched.get("tree") or []))
    out["b"] = {
        "trace_id": "%x" % tid, "problems": bad,
        "span_count": stitched.get("span_count", 0),
        "processes": stitched.get("processes", {}),
        "clock": stitched.get("clock", {}),
        "clock_bound_us": {str(p): max((n["clock_bound_us"] for n in flat
                                        if n["process"] == p), default=None)
                           for p in range(3)},
        "vars_processes": [p for p in range(3)
                           if f"== process {p} ==" in vbody],
        "vars_unreachable": "<unreachable" in vbody,
        "vars_errors": [ln for ln in vbody.splitlines()
                        if "<unreachable" in ln],
        "metrics_errors": [ln for ln in mbody.splitlines()
                           if "unreachable" in ln],
        "metrics_processes": [p for p in range(3)
                              if f'process="{p}"' in mbody],
        "metrics_typed": "# TYPE" in mbody}
    # (c) the decode drains and restarts: pod://pd drops ici://4 and
    # lists it again; one more Generate
    epoch0 = pod.epoch(refresh=True)
    t_drain = time.monotonic()
    m.put("drain", 1.0)
    dropped_s = revived_s = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        listed = "ici://4" in _pod_list("pd")
        if dropped_s is None and not listed:
            dropped_s = time.monotonic() - t_drain
        if dropped_s is not None and listed:
            revived_s = time.monotonic() - t_drain
            break
        time.sleep(0.005)
    m.get("restarted")
    # one Generate through the restarted decode, not retried: it must not
    # reach a mapping or a socket from before the stop
    after = generate(3000)
    out["c"] = {"epoch_before": epoch0, "dropped_s": dropped_s,
                "relisted_s": revived_s,
                "generate_after_restart_ok": not after.failed()}
    out["errors"] = errs
    ch.close()
    return out


# ---- chaos -------------------------------------------------------------

def run_chaos(m: _Member) -> dict:
    import socket as pysock
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.ici.pod import Pod, epoch_of
    from brpc_tpu_torch.ici.transport import ici_unlisten
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc.socket import Socket
    from brpc_tpu_torch.tools.overload_clients import attachment_tensor
    a = m.args
    pid, n = m.pid, m.n
    pod = Pod.join("chaos")
    lock = threading.Lock()
    served = [0]

    class EchoService(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            with lock:
                served[0] += len(cntl.request_attachment.device_refs())
            response.message = "t%d:%s" % (pid, request.message)
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    def serve():
        s = rpc.Server(rpc.ServerOptions(native_ici=False))
        s.add_service(EchoService())
        assert s.start(f"ici://{m.rank}") == 0
        return s

    server = serve()
    pod.wait_epoch(2 * n, timeout=60)
    members = pod.members(refresh=True)
    assert sorted(members) == list(range(n)), members
    assert all(members[p].serving == [2 * p] for p in range(n))
    out = {"pid": pid, "os_pid": os.getpid(), "pod_list": _pod_list("chaos")}
    dev = m.mesh.device(m.rank + 1)
    gen = torch.Generator(device=dev).manual_seed(100 + pid)
    # the attachment, on this process's second rank: a call to another
    # process crosses as kind 4 both ways
    att = m.mesh.own(torch.randint(0, 256, (a.attach,), dtype=torch.uint8,
                                   device=dev, generator=gen), m.rank + 1)
    ch = rpc.Channel()
    ch.init("pod://chaos", "rr", options=rpc.ChannelOptions(
        timeout_ms=15000, max_retry=3))
    failures = []
    seen = set()
    calls = [0]

    def fire(i):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(att)
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message=str(i)), EchoResponse)
        with lock:
            calls[0] += 1
        if cntl.failed():
            failures.append((i, cntl.error_code_, cntl.error_text))
            if cntl.error_code_ == rpc.errors.EINTERNAL:
                # a peer refused a device payload: its reason rides the
                # FIN into the call's text
                print(f"chaos member {m.pid}: call {i} failed "
                      f"{cntl.error_code_}: {cntl.error_text}",
                      file=sys.stderr, flush=True)
            return
        try:
            back = attachment_tensor(cntl.response_attachment)
        except ValueError as e:
            back = None
            failures.append((i, str(e)))
        if back is not None and not torch.equal(back, att):
            failures.append((i, "attachment differs"))
        with lock:
            seen.add(resp.message.split(":")[0])

    m.barrier("joined")
    m.zero()
    t_phase = time.monotonic()
    deadline = time.monotonic() + 60
    i = 0
    while time.monotonic() < deadline:
        fire(i)
        i += 1
        with lock:
            if len(seen) == n:
                break
    assert len(seen) == n and not failures, (seen, failures[:5])
    m.barrier("warm")
    # every process watches pod://chaos for ici://6 leaving it (process
    # 3's drain): the wall time it first saw it unlisted
    unlisted = {}

    def watch_drain():
        end = time.monotonic() + 120
        while time.monotonic() < end and "t" not in unlisted:
            if "ici://6" not in _pod_list("chaos"):
                unlisted["t"] = time.time()
            time.sleep(0.002)

    watcher = threading.Thread(target=watch_drain, daemon=True)
    watcher.start()
    live_server = server
    if pid not in (2, 3):
        stop_traffic = threading.Event()

        def traffic():
            j = 100000 * (pid + 1)
            while not stop_traffic.is_set():
                fire(j)
                j += 1
                time.sleep(0.01)

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        if pid == 0:
            # a direct channel to the kill target: the pre-kill socket id
            dch = rpc.Channel()
            dch.init("ici://4", options=rpc.ChannelOptions(
                timeout_ms=15000, max_retry=0))
            cntl = rpc.Controller()
            dch.call_method("EchoService.Echo", cntl,
                            EchoRequest(message="d"), EchoResponse)
            assert not cntl.failed(), cntl.error_text
            # this process's connection to ici://4 (process 2's own calls
            # here arrive on a server-side socket that may name rank 4 too)
            socks = [s for s in m.fabric_sockets() if s.remote_dev == 4
                     and not s.is_server_side]
            assert socks, "no fabric socket to the kill target"
            old_sid = socks[0].id
            m.put("presock", 1)
        m.put(f"traffic_on/{pid}", 1)
        m.get("revived", 180)
        with lock:
            seen.clear()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with lock:
                if "t2" in seen and "t3" in seen:
                    break
            time.sleep(0.05)
        stop_traffic.set()
        th.join(30)
        with lock:
            assert "t2" in seen, ("killed member never revived", seen)
            assert "t3" in seen, ("drained member never restarted", seen)
        if pid == 0:
            cntl = rpc.Controller()
            cntl.timeout_ms = 20000
            cntl.max_retry = 40
            cntl.retry_backoff_ms = 50
            resp = dch.call_method("EchoService.Echo", cntl,
                                   EchoRequest(message="post"), EchoResponse)
            assert not cntl.failed(), (cntl.error_code_, cntl.error_text)
            assert resp.message == "t2:post", resp.message
            # the pre-kill socket is revoked once its EOF is consumed
            end = time.monotonic() + 60
            while Socket.address(old_sid) is not None \
                    and time.monotonic() < end:
                time.sleep(0.05)
            assert Socket.address(old_sid) is None, \
                "stale pre-kill socket id must not resolve"
            new = [s for s in m.fabric_sockets() if s.remote_dev == 4
                   and not s.is_server_side and not s._peer_gone()]
            assert new and all(s.id != old_sid for s in new), (
                old_sid, [s.id for s in new])
            dch.close()
            out["old_socket_revoked"] = True
    elif pid == 2:
        # the kill: process-death-equivalent for the serving endpoint —
        # no GOODBYE, no withdraw; the record still claims serving
        for q in (0, 1):
            m.get(f"traffic_on/{q}", 60)
        m.get("presock", 60)
        ici_unlisten(m.rank)
        for s in m.fabric_sockets():
            if s.is_server_side:
                try:
                    s._conn.shutdown(pysock.SHUT_RDWR)
                except OSError:
                    pass
        m.put("killed", 1)
        time.sleep(1.0)
        gen_now = pod.members(refresh=True)[pid].gen
        assert gen_now == 2, ("the kill moved membership", gen_now)
        m.get("drained", 180)
        time.sleep(0.5)
        live_server = serve()                     # the revival
        m.put("revived", 1)
    else:
        m.get("killed", 60)
        time.sleep(1.0)
        t_mark = time.time()
        t0 = time.monotonic()
        server.stop(5.0)           # drain: GOODBYE + the pod's drain mark
        out["drain_s"] = time.monotonic() - t0
        assert out["drain_s"] < 4.0, out["drain_s"]
        m.put("drain_mark", t_mark)
        time.sleep(0.3)
        live_server = serve()
        m.put("drained", 1)
        m.get("revived", 180)
    watcher.join(5)
    m.barrier("done", 300)
    final = 2 * n + 4
    pod.wait_epoch(final, timeout=60)
    fm = pod.members(refresh=True)
    assert Pod.current() is pod
    assert epoch_of(fm) == final, (epoch_of(fm), final)
    assert all(fm[p].state == "up" for p in range(n))
    assert all(fm[p].serving == [2 * p] for p in range(n)), {
        p: fm[p].serving for p in fm}
    d = m.deltas()
    out.update(epoch=epoch_of(fm), expected_epoch=final,
               calls=calls[0], failures=failures[:5],
               failed=len(failures), attachments_served=served[0],
               phase_s=time.monotonic() - t_phase, counts=d,
               ipc=m.ipc(), drain_mark=m.get("drain_mark"),
               unlisted_at=unlisted.get("t"))
    m.barrier("exit", 300)
    ch.close()
    live_server.stop()
    pod.leave()
    m.leave_store()
    out["leaks"] = m.leaks()
    out["foreign"] = _foreign()
    return out


# ---- fanout ------------------------------------------------------------

def run_fanout(m: _Member) -> dict:
    """The compiled fan-out's cross-process leg over four members (see the
    module docstring).  Process 0 is the client; the members report their
    counts at the points the client names in the store."""
    import signal
    import numpy as np
    from brpc_tpu_torch import channels, rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.channels import collective_fanout as cf
    from brpc_tpu_torch.ici import route
    from brpc_tpu_torch.ici.pod import Pod
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.tools.overload_clients import attachment_tensor
    a = m.args
    pid, n = m.pid, m.n
    ranks = list(range(2 * n))
    flags.set_flag("ici_socket_window_bytes", FANOUT_WINDOW)
    flags.set_flag("ici_fanout_xproc_timeout_s", a.xproc_timeout)
    flags.set_flag("ici_fanout_reprobe_s", 1.0)
    if a.device == "cpu":
        # the CPU mesh runs the leg only when forced (device_plane)
        flags.set_flag("ici_device_plane_xproc_compiled", "on")

    def crash(x):
        if pid == FANOUT_VICTIM:
            os.kill(os.getpid(), signal.SIGKILL)
        return x * 2.0

    bodies = {"Scale": (lambda x: x * 2.0, "gather", "shard"),
              "Sum": (lambda x: x * 0.5, "sum", "replicate"),
              "Crash": (crash, "gather", "shard")}

    class Fan(rpc.Service):
        """The wire bodies of the per-member loop: the registered device
        bodies themselves, on the bytes as they arrived."""

        SERVICE_NAME = "Fan"

        def __init__(self, rank):
            self.rank = rank

        def _reply(self, cntl, fn):
            att = cntl.request_attachment
            if att.device_refs():
                x = attachment_tensor(att).view(torch.float32)
                cntl.response_attachment.append_device_array(m.mesh.own(
                    fn(x).contiguous().view(torch.uint8), self.rank))
            else:
                x = torch.from_numpy(np.frombuffer(
                    att.to_bytes(), np.uint8).copy()).view(torch.float32)
                cntl.response_attachment.append(fn(x).numpy().tobytes())

        @rpc.method(EchoRequest, EchoResponse)
        def Scale(self, cntl, request, response, done):
            self._reply(cntl, bodies["Scale"][0])
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Sum(self, cntl, request, response, done):
            self._reply(cntl, bodies["Sum"][0])
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Crash(self, cntl, request, response, done):
            self._reply(cntl, bodies["Crash"][0])
            done()

    def serve(r):
        s = rpc.Server(rpc.ServerOptions(native_ici=False))
        s.add_service(Fan(r))
        for name, (fn, merge, mapping) in bodies.items():
            s.register_collective(f"Fan.{name}", fn, merge=merge,
                                  mapping=mapping)
        assert s.start(f"ici://{r}") == 0, r
        return s

    # registered before the join, which publishes them (one gen bump)
    for name, (fn, merge, mapping) in bodies.items():
        cf.register_device_handler(f"Fan.{name}", fn, merge=merge,
                                   mapping=mapping)
    pod = Pod.join("fan")
    servers = {r: serve(r) for r in (m.rank, m.rank + 1)}
    pod.wait_epoch(3 * n, timeout=60)       # a join and two advertises
    members = pod.members(refresh=True)
    assert sorted(members) == list(range(n)) and all(
        sorted(members[p].serving) == [2 * p, 2 * p + 1]
        and "Fan.Scale" in members[p].coll for p in range(n)), {
        p: (r.serving, r.coll) for p, r in members.items()}
    out = {"pid": pid, "os_pid": os.getpid()}
    m.barrier("up")
    m.zero()

    def counts():
        d = m.deltas()
        x = cf.xproc_stats()
        d.update(rows_pulled=x["rows_pulled"],
                 rows_exported=x["rows_exported"],
                 entries_run=x["member_entries_run"])
        return d

    if pid == 0:
        out.update(_fanout_client(m, pod, cf, channels, rpc, route, flags,
                                  EchoRequest, EchoResponse, counts))
    else:
        m.get("ab_done", 600)
        m.put(f"ab_counts/{pid}", counts())
        if pid == FANOUT_RESTART_PID:
            m.get("restart", 300)
            for s in servers.values():
                s.stop()
            servers = {r: serve(r) for r in (m.rank, m.rank + 1)}
            m.put("restarted", 1)
        m.get("chaos_done", 600)
    m.sync()
    out["counts"] = counts()
    out["route"] = {k: v for k, v in route.collective_stats().items()
                    if v}
    out["ipc"] = m.ipc()
    out["payload_routes"] = route.route_stats()
    m.put(f"final/{pid}", 1)
    m.get("exit", 300)
    for s in servers.values():
        s.stop()
    pod.leave()
    m.leave_store(skip=(FANOUT_VICTIM,))
    out["leaks"] = m.leaks()
    out["xproc"] = cf.xproc_stats()
    out["foreign"] = _foreign()
    return out


def _fanout_client(m, pod, cf, channels, rpc, route, flags, EchoRequest,
                   EchoResponse, counts) -> dict:
    from brpc_tpu_torch.rpc import fault_injection as fi
    a = m.args
    n = m.n
    ranks = list(range(2 * n))
    dev = m.mesh.device(m.rank)
    res = {}
    chans = []

    def mk_pc(merge, shard_shape, devs=ranks, mapper=None, timeout_ms=30000):
        pc = channels.ParallelChannel()
        mapper = mapper or channels.ShardingCallMapper()
        merger = channels.CollectiveMerger(merge=merge, dtype="float32",
                                           shard_shape=shard_shape)
        for r in devs:
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(
                timeout_ms=timeout_ms, max_retry=0))
            pc.add_channel(ch, mapper=mapper, merger=merger)
            chans.append(ch)
        return pc

    def call(pc, op, method, want=None):
        cntl = rpc.Controller()
        cntl.fanout_operand = op
        t0 = time.perf_counter_ns()
        pc.call_method(method, cntl, EchoRequest(message="f"),
                       EchoResponse())
        m.sync()
        us = (time.perf_counter_ns() - t0) / 1000.0
        if want is not None:
            assert not cntl.failed(), (method, cntl.error_code_,
                                       cntl.error_text)
            assert cntl.fanout_route == want, (method, cntl.fanout_route,
                                               want)
        return cntl, us

    def degrades():
        return {k: v for k, v in route.collective_stats().items()
                if k.startswith("collective_degraded")}

    def leg(pc, op, method, compiled, calls, ref):
        flags.set_flag("ici_fanout_collective", compiled)
        lat = []
        try:
            for _ in range(calls):
                cntl, us = call(pc, op, method,
                                "collective" if compiled else "rpc")
                assert torch.equal(cntl.fanout_result, ref), (
                    method, compiled, "differs from the first result")
                lat.append(us)
        finally:
            flags.set_flag("ici_fanout_collective", True)
        return lat

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else -1.0

    deg0 = degrades()
    # (a) bench.py's shape: 8 x 512 float32, gather, in turns with the loop
    gen = torch.Generator(device=dev).manual_seed(1919)
    op = torch.randn(len(ranks), a.shard, device=dev, generator=gen)
    pc_a = mk_pc("gather", (a.shard,))
    # dial every member once before the legs: a new fabric socket sets up
    # its same-host tiers (the shm segment's pages are reserved at its
    # create), which must not eat the first announce's timeout
    for r in ranks:
        if not m.node.owns(r):
            cf._member_sock(r)
    first, _ = call(pc_a, op, "Fan.Scale", "collective")
    ref = first.fanout_result.clone()
    assert torch.equal(ref, op * 2.0), "the compiled gather is not op * 2"
    lat_c, lat_l = [], []
    turns = 4
    for t in range(turns):
        lat_c += leg(pc_a, op, "Fan.Scale", True, a.calls // turns, ref)
        lat_l += leg(pc_a, op, "Fan.Scale", False, a.calls // turns, ref)
    res["a"] = {"members": len(ranks), "shard": a.shard, "calls": len(lat_c),
                "collective_p50_us": pct(lat_c, 0.5),
                "collective_p99_us": pct(lat_c, 0.99),
                "loop_p50_us": pct(lat_l, 0.5),
                "loop_p99_us": pct(lat_l, 0.99)}
    compiled_calls = 1 + len(lat_c)
    # (b) 64 MiB: 8 shards of 8 MiB gathered, a 64 MiB operand replicated
    # and summed; compiled against degraded, bit for bit
    x = torch.randn(len(ranks), a.big // 4 // len(ranks), device=dev,
                    generator=gen)
    rep = torch.randn(a.big // 4, device=dev, generator=gen)
    b = {"bytes": a.big}
    for name, pc, operand, method, want in (
            ("gather", mk_pc("gather", (x.shape[1],)), x, "Fan.Scale",
             x * 2.0),
            ("sum", mk_pc("sum", None,
                          mapper=channels.ReplicateFanoutMapper()),
             rep, "Fan.Sum", None)):
        c1, _ = call(pc, operand, method, "collective")
        got = c1.fanout_result.clone()
        if want is not None:
            assert torch.equal(got, want), f"compiled {name} differs"
        lat_c = leg(pc, operand, method, True, a.big_calls, got)
        lat_d = leg(pc, operand, method, False, a.big_calls, got)
        b[name] = {"compiled_ms_p50": pct(lat_c, 0.5) / 1e3,
                   "compiled_ms_p99": pct(lat_c, 0.99) / 1e3,
                   "degraded_ms_p50": pct(lat_d, 0.5) / 1e3,
                   "degraded_ms_p99": pct(lat_d, 0.99) / 1e3}
        compiled_calls += 1 + len(lat_c)
    del x, rep
    res["b"] = b
    res["degrades_ab"] = {k: v - deg0.get(k, 0) for k, v in
                          degrades().items() if v != deg0.get(k, 0)}
    res["compiled_calls_ab"] = compiled_calls
    m.sync()
    res["ab_counts"] = {0: counts()}
    m.put("ab_done", 1)
    for q in range(1, n):
        res["ab_counts"][q] = m.get(f"ab_counts/{q}")

    # (c) chaos
    c = {}
    base = route.collective_stats()

    def delta():
        now = route.collective_stats()
        return {k: v - base.get(k, 0) for k, v in now.items()
                if v != base.get(k, 0)}

    # 1. the member serving ici://4 killed mid-fan-out, by the plan
    plan = fi.FabricFaultPlan(collective_kill_device=4)
    routes = []
    with fi.inject_fabric(plan):
        for _ in range(2):
            cntl, _ = call(pc_a, op, "Fan.Scale", "rpc")
            assert torch.equal(cntl.fanout_result, ref)
            routes.append(cntl.fanout_route)
    assert plan.injected["collective"] == 1, plan.injected
    cntl, _ = call(pc_a, op, "Fan.Scale", "rpc")          # stays down
    routes.append(cntl.fanout_route)
    e0 = pod.epoch(refresh=True)
    m.put("restart", 1)
    m.get("restarted", 120)
    pod.wait_epoch(e0 + 4, timeout=60)     # 2 withdraws, 2 advertises
    cntl, _ = call(pc_a, op, "Fan.Scale", "collective")
    routes.append(cntl.fanout_route)
    d = delta()
    assert d.get("collective_degraded_member_killed") == 1 \
        and d.get("collective_revived_member_killed") == 1, d
    c["kill"] = {"routes": routes, "failed_calls": 0, "epoch_moved":
                 [e0, pod.epoch()], "delta": d}
    # one call on the per-member loop dials the restarted member's new
    # sockets here, not inside the black-holed call's timeout below
    leg(pc_a, op, "Fan.Scale", False, 1, ref)
    # 2. one announce black-holed
    base = route.collective_stats()
    plan = fi.FabricFaultPlan(collective_drop_announces=1)
    with fi.inject_fabric(plan):
        cntl, us = call(pc_a, op, "Fan.Scale", "rpc")
    assert torch.equal(cntl.fanout_result, ref)
    assert us / 1e6 < a.xproc_timeout + 1.0, us
    d = delta()
    assert d.get("collective_degraded_announce_refused") == 1, d
    assert plan.injected["coll_announce_drop"] == 1, plan.injected
    time.sleep(1.2)                         # the transient reprobe window
    cntl, _ = call(pc_a, op, "Fan.Scale", "collective")
    c["drop"] = {"route": "rpc", "call_s": us / 1e6, "failed_calls": 0,
                 "delta": d, "then": cntl.fanout_route}
    # 3. a member killed by SIGKILL after accepting, before its result
    base = route.collective_stats()
    victim_ranks = [2 * FANOUT_VICTIM, 2 * FANOUT_VICTIM + 1]
    pc_crash = mk_pc("gather", (a.shard,), timeout_ms=FANOUT_CRASH_RPC_MS)
    cntl, us = call(pc_crash, op, "Fan.Crash")
    c["sigkill"] = {"route": cntl.fanout_route, "call_s": us / 1e6,
                    "failed": cntl.failed(), "error": cntl.error_text}
    assert cntl.fanout_route == "rpc", cntl.fanout_route
    assert us / 1e6 < a.xproc_timeout + FANOUT_CRASH_RPC_MS / 1e3 + 2.0, us
    # the victim is gone: no ping answers; the supervisor's eviction
    # takes it out of the pod
    end = time.monotonic() + 30
    while m.node.ping(victim_ranks[0], timeout=0.5) \
            and time.monotonic() < end:
        time.sleep(0.1)
    e1 = pod.epoch(refresh=True)
    assert pod.evict(FANOUT_VICTIM)
    pod.wait_epoch(e1 + 1, timeout=30)
    pc_all = mk_pc("gather", (a.shard,), timeout_ms=FANOUT_CRASH_RPC_MS)
    before = route.collective_stats().get(
        "collective_ineligible_member_down", 0)
    cntl, _ = call(pc_all, op, "Fan.Scale")
    c["after_evict"] = {
        "route": cntl.fanout_route,
        "member_down": route.collective_stats().get(
            "collective_ineligible_member_down", 0) - before}
    assert cntl.fanout_route == "rpc" and c["after_evict"]["member_down"] \
        == 1, c["after_evict"]
    # the survivors' ranks still fan out on the cross-process leg
    live = [r for r in ranks if r not in victim_ranks]
    pc_live = mk_pc("gather", (a.shard,), devs=live)
    time.sleep(1.2)                         # exec_failed's reprobe window
    cntl, _ = call(pc_live, op[:len(live)].contiguous(), "Fan.Scale",
                   "collective")
    assert torch.equal(cntl.fanout_result, op[:len(live)] * 2.0)
    c["survivors"] = {"route": cntl.fanout_route, "ranks": live}
    c["sigkill"]["delta"] = delta()
    res["c"] = c
    m.put("chaos_done", 1)
    for q in range(1, n):
        if q != FANOUT_VICTIM:
            m.get(f"final/{q}", 120)
    for ch in chans:
        ch.close()
    m.put("exit", 1)
    res["victim_os_pid"] = m.node.peer_info(FANOUT_VICTIM)["os_pid"]
    return res


_port_calls = itertools.count()


def free_port() -> int:
    """A free port of 127.0.0.1 for a store or a listener that another
    process binds.  A port that ``bind(("127.0.0.1", 0))`` hands out is in
    the kernel's ephemeral range, where any socket's connect may take it
    before the other process binds it; this one is below that range,
    probed from a seed of (process, call), so test processes running at
    once try different ports, and bound once to check it is free."""
    import hashlib
    import socket
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 0
    span = lo - 10000
    if span >= 1000:
        seed = f"{os.getpid()}|{next(_port_calls)}".encode()
        h = int.from_bytes(hashlib.sha1(seed).digest()[:4], "big")
        for i in range(64):
            port = 10000 + (h + i * 131) % span
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_members(scenario: str, nproc: int, device: str = "cuda",
                extra=(), timeout: float = 600.0, cwd=None) -> list:
    """Start ``nproc`` members of ``scenario`` as fresh interpreters, all
    at once (a process takes seconds to reach the card), and return each
    one's RESULT (None for a member that printed none) beside its exit
    code and output: ``[(rc, result, output), ...]``.  A member still
    running at ``timeout`` is killed."""
    import subprocess
    import tempfile
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for pid in range(nproc):
        log = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "brpc_tpu_torch.tools.pod_peer", coord,
             str(pid), str(nproc), scenario, "--device", device,
             *map(str, extra)],
            cwd=cwd, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    out = []
    for proc, log in procs:
        try:
            proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        out.append((proc.returncode,
                    json.loads(lines[-1][7:]) if lines else None, text))
    return out


def main(argv=None) -> int:
    import faulthandler
    _exit_with_parent()
    # a member killed by a signal (an abort in interpreter teardown)
    # prints every thread's stack with its output
    faulthandler.enable(all_threads=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coord")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("scenario", choices=("generate", "chaos", "fanout"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--prompts", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--attach", type=int, default=64 << 10)
    ap.add_argument("--shard", type=int, default=512)
    ap.add_argument("--calls", type=int, default=80)
    ap.add_argument("--big", type=int, default=64 << 20)
    ap.add_argument("--big-calls", type=int, default=10)
    ap.add_argument("--xproc-timeout", type=float, default=2.0)
    args = ap.parse_args(argv)
    m = _Member(args)
    run = {"generate": run_generate, "chaos": run_chaos,
           "fanout": run_fanout}[args.scenario]
    out = run(m)
    m.node.quiesce()
    # one write: another thread's log line (stderr, the same file for
    # run_members) cannot land between the line and its newline
    sys.stdout.write("RESULT " + json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
