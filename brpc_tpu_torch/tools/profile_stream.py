"""Where a stream of DEVICE chunks spends its time, on one card.

    python3 -m brpc_tpu_torch.tools.profile_stream [--chunks N]

Drives ``chip_smoke.py``'s phase 11 (b) (IciMesh(ranks=8) on the card,
4 MiB chunks of seeded bytes owned by rank 4 written to a server on
ici://3 through a 64 MiB stream window, the socket window at 256 MiB, the
server's handler holding each chunk equal to its source on the card),
then measures two windows apart from each other:

  * the device's idle share: ``torch.profiler`` device time of every
    kernel and copy over the wall time of a stream of ``--chunks``;
  * sampled host stacks over another such stream, charged by role: the
    writer (the main thread), the device poller, and the scheduler
    workers (the server's reader, the stream's delivery queue, the
    handler).  Read the shares, not the times: the sampler slows the
    stream.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import torch

from .profile_echo import device_busy_share, sample_stacks

CHUNK = 4 << 20
WINDOW = 64 << 20


def _role(name: str, frame) -> str:
    if name == "MainThread":
        return "writer"
    if name.startswith("device_poller"):
        return "poller"
    if name.startswith("bthread_worker"):
        return "worker"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=128,
                    help="4 MiB chunks in each measured stream")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stream: needs a CUDA device", file=sys.stderr)
        return 1
    from .. import policy  # noqa: F401  (registers tpu_std)
    from .. import rpc
    from ..butil import flags
    from ..butil.iobuf import IOBuf
    from ..ici.mesh import IciMesh
    from ..proto.echo_pb2 import EchoRequest, EchoResponse

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    mesh = IciMesh(ranks=8)
    IciMesh.set_default(mesh)
    flags.set_flag("ici_socket_window_bytes", 256 << 20)
    n = args.chunks
    src = mesh.own(torch.randint(
        0, 256, (n * CHUNK,), dtype=torch.uint8, device=mesh.device(0),
        generator=torch.Generator(device=mesh.device(0)).manual_seed(11)), 4)

    class Check(rpc.StreamInputHandler):
        """Each stream writes chunks 0, 1, ... from its start: the i-th
        chunk since ``start`` must equal the source's i-th slice."""

        def __init__(self):
            self.seen = self.equal = self.start = 0
            self.closed = threading.Event()

        def on_received_messages(self, sid, msgs):
            for m in msgs:
                i = self.seen - self.start
                self.seen += 1
                ref = m.backing_block(0)
                self.equal += torch.equal(
                    ref.block.data[ref.offset:ref.offset + ref.length],
                    src[i * CHUNK:(i + 1) * CHUNK])

        def on_closed(self, sid):
            self.closed.set()

    check = Check()

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Open(self, cntl, request, response, done):
            rpc.stream_accept(cntl, rpc.StreamOptions(handler=check,
                                                      max_buf_size=WINDOW))
            done()

    server = rpc.Server()
    server.add_service(Sink())
    if server.start("ici://3") != 0:
        print("profile_stream: server start on ici://3 failed",
              file=sys.stderr)
        return 1
    ch = rpc.Channel()
    ch.init("ici://3", options=rpc.ChannelOptions(timeout_ms=30000))
    try:
        cntl = rpc.Controller()
        st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=WINDOW))
        ch.call_method("Sink.Open", cntl, EchoRequest(message="o"),
                       EchoResponse)
        if cntl.failed() or not st.wait_connected(10):
            raise RuntimeError(f"stream handshake: {cntl.error_text}")

        def stream(k: int) -> None:
            check.start = goal = check.seen
            goal += k
            for i in range(k):
                buf = IOBuf()
                buf.append_device_array(src[i * CHUNK:(i + 1) * CHUNK])
                if st.write(buf, timeout=30) != 0:
                    raise RuntimeError(f"stream write {i} failed")
            deadline = time.monotonic() + 60
            while check.seen < goal and time.monotonic() < deadline:
                time.sleep(0.0005)
            if check.seen < goal:
                raise RuntimeError("the stream's chunks never all arrived")

        stream(16)                                # warm: build, streams
        t0 = time.perf_counter()
        stream(n)
        wall = time.perf_counter() - t0
        out = {"chunks": n, "chunk": CHUNK, "unprofiled_mbps":
               n * CHUNK / wall / 1e6,
               "profile": device_busy_share(lambda: stream(n), top=4),
               "stacks": sample_stacks(lambda: stream(n), role_of=_role,
                                       top=24)}
        st.close()
        check.closed.wait(30)
        out["equal"] = check.equal
        out["seen"] = check.seen
    finally:
        ch.close()
        server.stop()
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] == out["seen"] else 1


if __name__ == "__main__":
    sys.exit(main())
