"""Runnable disaggregated-serving demo (one process, 8 ranks).

Starts one prefill worker (ici://1), two decode workers (ici://2,
ici://3) and a router (mem://disagg-router), generates a few completions
and verifies them against the single-process reference: the KV handoff
crossed the device plane, so the tokens must be identical.

    python -m brpc_tpu_torch.examples.disagg_serving.demo            # card
    python -m brpc_tpu_torch.examples.disagg_serving.demo --device cpu

On the card the 8 ranks share the visible devices and every KV handoff
is one launch of the ``p2p_copy`` kernel; on the CPU its plain version
moves the bytes.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the mesh, the pools and the steps live")
    args = ap.parse_args(argv)

    import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import device_plane
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.examples.disagg_serving.model import (
        reference_generate)
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        close_services, start_decode_worker, start_prefill_worker,
        start_router)

    mesh = IciMesh(ranks=8, device=args.device)
    IciMesh.set_default(mesh)
    # on a CPU mesh the plane engages only when asked (the CI datapath)
    flags.set_flag("ici_device_plane_host_mesh", args.device == "cpu")
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    prefill = start_prefill_worker("ici://1")
    decode_a = start_decode_worker("ici://2")
    decode_b = start_decode_worker("ici://3")
    router = start_router("mem://disagg-router", "ici://1",
                          ["ici://2", "ici://3"])
    ch = rpc.Channel()
    try:
        ch.init("mem://disagg-router",
                options=rpc.ChannelOptions(timeout_ms=60000))
        plane = device_plane.plane()
        before = plane.stats()["transfers"]
        ok = 0
        for i in range(4):
            tokens = [(7 * i + j) % 997 for j in range(96 + 16 * i)]
            cntl = rpc.Controller()
            resp = ch.call_method(
                "Router.Generate", cntl,
                EchoRequest(message=json.dumps(
                    {"tokens": tokens, "steps": 8})), EchoResponse)
            if cntl.failed():
                print(f"prompt {i}: failed: {cntl.error_text}")
                return 1
            out = json.loads(resp.message)
            want = reference_generate(tokens, 8, device=mesh.device(0))
            if out["tokens"] != want:
                print(f"prompt {i}: tokens {out['tokens']} != {want}")
                return 1
            ok += 1
            print(f"prompt {i}: {out['kv_bytes']} KV bytes -> "
                  f"{out['decode_worker']} -> tokens {out['tokens'][:4]}…"
                  f" verified")
        stats = plane.stats()
        print("device plane:", stats)
        for srv in (decode_a, decode_b):
            for svc in srv.services().values():
                if not hasattr(svc, "describe_serving"):
                    continue             # the builtin admin services
                d = svc.describe_serving()
                print(f"serving[{srv.listen_endpoint}]: "
                      f"steps={d['scheduler']['steps']} "
                      f"pool_blocks_used={d['pool']['blocks_used']} "
                      f"on {d['pool']['device']}")
        if stats["transfers"] - before < ok:
            print("the KV handoff did not cross the device plane")
            return 1
        print(f"disagg_serving demo: {ok}/4 completions verified "
              f"({stats['transfers'] - before} device-plane transfers)")
        return 0
    finally:
        ch.close()
        close_services(router, prefill, decode_a, decode_b)


if __name__ == "__main__":
    sys.exit(main())
