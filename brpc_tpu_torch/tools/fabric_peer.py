"""A peer process of the multi-process fabric: serves ranks of the mesh.

    python -m brpc_tpu_torch.tools.fabric_peer HOST:PORT TOKEN \\
        [--device cuda|cpu] [--threshold BYTES] [--rpc-dump DIR]

Joins as process 1 of 2 the fabric whose store process 0 hosts at
``HOST:PORT``, owns ranks 0-3 of an 8-rank mesh and serves, on ``ici://0``
(the Python plane) and on a TCP listener (``127.0.0.1:0``,
``idle_timeout_s=1`` and an ``internal_port``):

  * ``Sink.Push``: returns its request's attachment (``sleep:<s>`` first
    sleeps that long);
  * ``Sink.Stats``: this process's counts as JSON (``reset`` zeroes them):
    copy-kernel launches, cross-process transfers received (kind 4), kind-1
    rows pulled and rows still staged, attachments received, IPC opens and
    cache hits, live mappings and segments;
  * ``Sink.Stop``: ``{"grace_s": g}`` drains and stops the servers, then
    the process exits;
  * ``Sink.Overload``: runs phase 10's paced overload clients
    (:mod:`.overload_clients`) against a target in another process and
    returns their per-stream results;
  * ``Sink.Absorb``: counts its request's attachment bytes and answers
    with no attachment (a one-way sink for bandwidth legs);
  * ``Sink.Plan``: installs the ``FabricFaultPlan`` whose keyword
    arguments are the JSON body in this process (an empty body clears it)
    and answers with the cleared plan's ``injected`` counts;
  * ``Stream.Start``: accepts a stream and counts the bytes it receives;
    with the message ``verify`` it also checks every chunk against its
    sequence tag (an 8-digit number, then ``seq % 251`` repeated);
  * ``Sink.Forward``: takes its request's attachment as one tensor and
    answers JSON with its device, data pointer and ``rank_of``; with the
    message ``forward`` it also forwards the tensor into a call on this
    process's native door (``Keep.Hold`` on ``ici://1``, started at the
    first forward), which keeps what arrives, and adds the call's error
    and the moves of ``native_plane.relocation_stats()``;
  * ``Sink.Kept``: the SHA-256 of the first tensor ``Keep.Hold`` kept, its
    rank and how many it kept (``reset`` forgets them).

``--rpc-dump DIR`` turns ``rpc_dump`` on with ``DIR`` as its directory,
one file of at most 16 requests (the plane-frame trace is written there).

Its device-plane threshold (``--threshold``, default
:data:`DEVICE_THRESHOLD`) and socket window (:data:`SOCKET_WINDOW`) are set
by the process that drives it too.
It publishes ``{"tcp_port", "internal_port", "os_pid"}`` under
``fabric_peer/<TOKEN>`` in the store once it serves, and prints its final
counts as one JSON line when it stops; it exits when the process that
started it dies.  With ``--device cpu`` it counts the copy's plain version
as launches.  ``chip_smoke.py`` phase 17 and
``tests/test_torch_fabric.py`` start it as a fresh interpreter.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import threading
import time
from datetime import timedelta

import torch

# the device-plane threshold (so a 4 KiB payload rides the device leg) and
# the socket window (a 4 MiB frame fits whole) of both processes: the
# driving process reads the same pair
DEVICE_THRESHOLD = 4 << 10
SOCKET_WINDOW = 64 << 20


def _exit_with_parent() -> None:
    """The peer outlives no parent: when the process that started it dies
    (a killed script or test), the peer exits too."""
    parent = os.getppid()
    if parent == 1:                  # orphaned before it got this far
        os._exit(1)

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, name="parent_watch", daemon=True).start()  # fablint: thread-quiesced(os._exit: the watch ends only by ending the process)


def main(argv=None) -> int:
    _exit_with_parent()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coord")
    ap.add_argument("token")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--threshold", type=int, default=DEVICE_THRESHOLD)
    ap.add_argument("--rpc-dump", default="")
    args = ap.parse_args(argv)

    import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
    from torch.distributed import TCPStore
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import device_plane, fabric, ipc_pull
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.tools import overload_clients

    copy_mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    plain = [0]
    if args.device == "cpu":
        inner = copy_mod.p2p_copy_plain

        def counted(src, dst):
            plain[0] += 1
            return inner(src, dst)

        copy_mod.p2p_copy_plain = counted
        flags.set_flag("ici_device_plane_host_mesh", True)

    def launches() -> int:
        return plain[0] if args.device == "cpu" \
            else copy_mod.p2p_copy.launches

    mesh = IciMesh(ranks=8, device=args.device)
    IciMesh.set_default(mesh)
    flags.set_flag("ici_device_plane_threshold", args.threshold)
    flags.set_flag("ici_socket_window_bytes", SOCKET_WINDOW)
    if args.rpc_dump:
        flags.set_flag("rpc_dump_dir", args.rpc_dump)
        flags.set_flag("rpc_dump_max_files", 1)
        flags.set_flag("rpc_dump_max_requests_in_one_file", 16)
        flags.set_flag("rpc_dump", True)
    node = fabric.FabricNode.initialize(args.coord, 2, 1, ranks=range(4),
                                        mesh=mesh)
    host, _, port = args.coord.rpartition(":")
    kv = TCPStore(host, int(port), is_master=False,
                  timeout=timedelta(seconds=60))
    plane = device_plane.plane()
    lock = threading.Lock()
    counts = {"attachments": 0, "stream_bytes": 0, "stream_chunks": 0,
              "stream_bad": 0, "absorbed": 0}
    plan = [None]
    base = {"launches": 0, "received": 0, "xfer_pulled": 0}
    quit_evt = threading.Event()
    servers = []
    stoppers = []        # Stop's threads, joined before the peer exits

    def snapshot() -> dict:
        socks = [s for s in _live_fabric_sockets(fabric)]
        return {"launches": launches() - base["launches"],
                "received": plane.remote_received
                - base["received"],
                # kind 1: rows this process pulled, and its own rows still
                # staged for the peer's pull
                "xfer_pulled": fabric.xfer_stats()["pulled"]
                - base["xfer_pulled"],
                "staged": sum(len(s._staged) for s in socks),
                "attachments": counts["attachments"],
                "stream_bytes": counts["stream_bytes"],
                "stream_chunks": counts["stream_chunks"],
                "stream_bad": counts["stream_bad"],
                "absorbed": counts["absorbed"],
                "shm_claimed": sum(s.shm_bytes_claimed for s in socks),
                "bulk_claimed": sum(s.bulk_bytes_claimed for s in socks),
                "ipc_opens": sum(s.ipc_stats()["opens"] for s in socks),
                "ipc_hits": sum(s.ipc_stats()["hits"] for s in socks),
                "mapped": sum(s.ipc_stats()["mapped"] for s in socks),
                "active": plane.active_transfers(),
                "segments": len(ipc_pull.live_segments()),
                "os_pid": os.getpid(),
                # the port stands alone: no JAX, nothing of brpc_tpu
                "foreign": sorted(m for m in sys.modules
                                  if m in ("jax", "brpc_tpu")
                                  or m.startswith(("jax.", "jaxlib",
                                                   "brpc_tpu.")))}

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            with lock:
                counts["attachments"] += len(
                    cntl.request_attachment.device_refs())
            if request.message.startswith("sleep:"):
                time.sleep(float(request.message[6:]))
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Stats(self, cntl, request, response, done):
            if request.message == "reset":
                with lock:
                    for k in counts:
                        counts[k] = 0
                base["launches"] = launches()
                base["received"] = plane.remote_received
                base["xfer_pulled"] = fabric.xfer_stats()["pulled"]
            response.message = json.dumps(snapshot())
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Absorb(self, cntl, request, response, done):
            with lock:
                counts["absorbed"] += len(cntl.request_attachment)
                response.message = str(counts["absorbed"])
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Plan(self, cntl, request, response, done):
            from brpc_tpu_torch.rpc import fault_injection
            old = plan[0]
            kw = json.loads(request.message) if request.message else None
            plan[0] = fault_injection.FabricFaultPlan(**kw) \
                if kw is not None else None
            fault_injection.install_fabric(plan[0])
            response.message = json.dumps(
                old.injected if old is not None else {})
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Stop(self, cntl, request, response, done):
            grace = float(json.loads(request.message or "{}")
                          .get("grace_s", 0.0))
            response.message = "stopping"
            done()

            def stop():
                for s in servers:
                    s.stop(grace)
                quit_evt.set()

            t = threading.Thread(target=stop, daemon=True)
            stoppers.append(t)
            t.start()

        @rpc.method(EchoRequest, EchoResponse)
        def Overload(self, cntl, request, response, done):
            spec = json.loads(request.message)
            bank = overload_clients.attachment_bank(
                mesh, spec["ranks"], spec["payload"], spec["patterns"],
                mesh.device(spec["ranks"][0]))
            response.message = json.dumps(overload_clients.run_overload(
                rpc, spec["target"], spec["base"], spec["over"],
                spec["unloaded_s"], spec["overload_s"], bank,
                overload_clients.attachment_tensor))
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Forward(self, cntl, request, response, done):
            t = overload_clients.attachment_tensor(cntl.request_attachment)
            info = {"device": str(t.device), "ptr": t.data_ptr(),
                    "rank_of": mesh.rank_of(t)}
            if request.message == "forward":
                from brpc_tpu_torch.ici import native_plane
                ch = keeper()
                r0 = native_plane.relocation_stats()
                c2 = rpc.Controller()
                c2.request_attachment.append_device_array(t)
                resp2 = ch.call_method("Keep.Hold", c2,
                                       EchoRequest(message="k"),
                                       EchoResponse)
                r1 = native_plane.relocation_stats()
                info.update(error=c2.error_text if c2.failed() else None,
                            native=ch._native_ici is not None,
                            callee_rank=resp2.message,
                            relocated={k: r1[k] - r0[k] for k in r1})
            del t
            response.message = json.dumps(info)
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Kept(self, cntl, request, response, done):
            import hashlib
            with lock:
                first = kept[0] if kept else None
                n = len(kept)
                if request.message == "reset":
                    kept.clear()
            # the digest's copy runs outside the lock Hold takes
            info = {"n": n, "rank": mesh.rank_of(first)
                    if first is not None else None,
                    "sha256": hashlib.sha256(
                        first.cpu().numpy().tobytes()).hexdigest()
                    if first is not None else None}
            response.message = json.dumps(info)
            done()

    kept = []
    keep_ch = []

    class Keep(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Hold(self, cntl, request, response, done):
            t = overload_clients.attachment_tensor(cntl.request_attachment)
            with lock:
                kept.append(t)
            response.message = str(mesh.rank_of(t))
            done()

    def keeper():
        """The channel to Keep.Hold on this process's native door."""
        with lock:
            if not keep_ch:
                srv = rpc.Server()
                srv.add_service(Keep())
                assert srv.start(f"ici://{node.devices[1]}") == 0
                servers.append(srv)
                ch = rpc.Channel()
                ch.init(f"ici://{node.devices[1]}",
                        options=rpc.ChannelOptions(timeout_ms=30000,
                                                   max_retry=0))
                keep_ch.append(ch)
            return keep_ch[0]

    class Stream(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Start(self, cntl, request, response, done):
            verify = request.message == "verify"

            class Handler:
                def on_received_messages(self, sid, msgs):
                    bad = 0
                    if verify:
                        for m in msgs:
                            data = m.to_bytes()
                            seq = int(data[:8])
                            if data[8:] != bytes([seq % 251]) * (
                                    len(data) - 8):
                                bad += 1
                    with lock:
                        counts["stream_bytes"] += sum(len(m) for m in msgs)
                        counts["stream_chunks"] += len(msgs)
                        counts["stream_bad"] += bad

                def on_closed(self, sid):
                    pass

            rpc.stream_accept(cntl, rpc.StreamOptions(
                handler=Handler(), max_buf_size=8 << 20))
            response.message = "ok"
            done()

    # handlers that sleep run on the backup pool, not scheduler workers
    ici_srv = rpc.Server(rpc.ServerOptions(
        native_ici=False, usercode_in_pthread=True,
        usercode_backup_threads=32))
    ici_srv.add_service(Sink())
    ici_srv.add_service(Stream())
    tcp_srv = rpc.Server(rpc.ServerOptions(idle_timeout_s=1,
                                           internal_port=0))
    tcp_srv.add_service(Sink())
    tcp_srv.add_service(Stream())
    assert ici_srv.start(f"ici://{node.devices[0]}") == 0
    assert tcp_srv.start("127.0.0.1:0") == 0
    servers += [ici_srv, tcp_srv]
    kv.set(f"fabric_peer/{args.token}", json.dumps({
        "tcp_port": tcp_srv.listen_port,
        "internal_port": tcp_srv.internal_port, "os_pid": os.getpid()}))
    quit_evt.wait()
    for t in stoppers:
        t.join()
    if args.device == "cuda":
        torch.cuda.synchronize()
    print(json.dumps(snapshot()), flush=True)
    node.quiesce()
    return 0


def _live_fabric_sockets(fabric):
    from brpc_tpu_torch.rpc.socket import list_sockets
    return [s for s in list_sockets()
            if isinstance(s, fabric.FabricSocket) and not s.failed]


if __name__ == "__main__":
    raise SystemExit(main())
