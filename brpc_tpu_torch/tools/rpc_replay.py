"""rpc_replay: replay rpc_dump files against a server.

Reference: tools/rpc_replay, ported from :mod:`brpc_tpu.tools.rpc_replay`.
It reads the frames :mod:`..rpc.rpc_dump` recorded, re-sends each with a
fresh correlation id so its response resolves normally, and reports the
success count and rate::

    python -m brpc_tpu_torch.tools.rpc_replay --server ici://0 \\
        --dir ./rpc_dump [--times 2] [--qps 0]

``run_replay(..., collect=True)`` also returns each call's response
payload and attachment bytes, in file order, under ``"responses"``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def run_replay(server: str, dump_dir: str, times: int = 1, qps: int = 0,
               timeout_s: float = 10.0, out=sys.stderr,
               collect: bool = False) -> dict:
    import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
    from brpc_tpu_torch.bthread import id as bthread_id
    from brpc_tpu_torch.butil.endpoint import parse_endpoint
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.policy import tpu_std
    from brpc_tpu_torch.proto import rpc_meta_pb2 as meta_pb
    from brpc_tpu_torch.rpc import rpc_dump
    from brpc_tpu_torch.rpc.controller import Controller
    from brpc_tpu_torch.rpc.input_messenger import InputMessenger
    from brpc_tpu_torch.rpc.socket_map import SocketMap

    files = rpc_dump.list_dump_files(dump_dir)
    if not files:
        print(json.dumps({"error": f"no dump files in {dump_dir}"}), file=out)
        return {"sent": 0, "ok": 0}

    ep = parse_endpoint(server)
    sock = SocketMap.instance().get_socket(ep, InputMessenger(server=None))
    interval = 1.0 / qps if qps > 0 else 0.0
    inflight = []
    t0 = time.monotonic()
    for _ in range(times):
        for path in files:
            for frame in rpc_dump.load_dumped_frames(path):
                meta_size = int.from_bytes(frame[4:8], "big")
                meta = meta_pb.RpcMeta()
                meta.ParseFromString(
                    frame[tpu_std.HEADER_SIZE:tpu_std.HEADER_SIZE + meta_size])
                body = frame[tpu_std.HEADER_SIZE + meta_size:]
                cntl = Controller()
                cntl.timeout_ms = int(timeout_s * 1000)
                cntl.max_retry = 0
                cntl._cid = bthread_id.create_ranged(
                    cntl, cntl._on_rpc_event, 1)
                cid = bthread_id.with_version(cntl._cid, 0)
                cntl._start_us = time.monotonic_ns() // 1000
                meta.correlation_id = cid
                buf = IOBuf()
                buf.append(body)
                sock.write(tpu_std.pack_frame(meta, buf), notify_cid=cid)
                inflight.append(cntl)
                if interval:
                    time.sleep(interval)

    ok = errors_n = 0
    responses = []
    deadline = time.monotonic() + timeout_s
    for cntl in inflight:
        try:
            cntl.join(max(deadline - time.monotonic(), 0.01))
            failed = cntl.failed()
        except TimeoutError:
            failed = True
        if failed:
            errors_n += 1
        else:
            ok += 1
        if collect:
            att = cntl._peek_response_attachment()
            responses.append((cntl.error_code_, cntl.response,
                              att.to_bytes() if att is not None else b""))
    elapsed = time.monotonic() - t0
    sent = len(inflight)
    result = {"sent": sent, "ok": ok, "errors": errors_n,
              "elapsed_s": round(elapsed, 2), "files": len(files),
              "qps": round(sent / elapsed, 1) if elapsed else 0}
    print(json.dumps(result), file=out)
    if collect:
        result["responses"] = responses
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server", required=True)
    ap.add_argument("--dir", default="./rpc_dump")
    ap.add_argument("--times", type=int, default=1)
    ap.add_argument("--qps", type=int, default=0)
    args = ap.parse_args(argv)
    run_replay(args.server, args.dir, args.times, args.qps, out=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
