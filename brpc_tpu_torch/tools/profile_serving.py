"""Where a disaggregated-serving Generate spends its time, on one card.

    python3 -m brpc_tpu_torch.tools.profile_serving [--generates N]

Starts the serving stack of ``chip_smoke.py``'s phase 8 (IciMesh(ranks=8)
on the card, the router on mem://, prefill on rank 1, decode on ranks 2
and 3 with pools of ``--blocks`` blocks of 16 tokens x 1,024 B, plane
threshold 64 KiB), warms it, then measures windows apart from each other:

  * the device's idle share over 20 Generates of 512 tokens x 64 steps
    from 2 client threads (``torch.profiler``: device time of every
    kernel and copy over the window's wall time), with the top device
    operations;
  * the same over 64 batched steps at roster 64 (64 sessions loaded
    through Decode.LoadKv, stepped by a scheduler on the decode pool);
  * sampled host stacks over ``--generates`` Generates: every sample of a
    bthread worker, the step loop, the device poller and the clients is
    charged to its ROLE — the service method on its stack (Router
    Generate, Prefill, LoadKv, Decode), the step loop, the poller or the
    client — and to the innermost frame in this package.  The sampler
    shortens ``sys.setswitchinterval``, so read the shares, not the times.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading

import numpy as np
import torch

PROMPT, STEPS, ROSTER = 512, 64, 64
_ROLES = {"Generate": "router", "Prefill": "prefill", "LoadKv": "decode",
          "Decode": "decode", "step_once": "step loop",
          "_process_message": "rpc dispatch"}


def role_of(name: str, frame):
    """The role a thread's sample is charged to: the service method or
    loop on its stack, else the poller or a client; None for idle
    workers, timers and the main thread (it only joins the clients)."""
    pkg = os.sep + "brpc_tpu_torch" + os.sep
    f = frame
    while f is not None:
        r = _ROLES.get(f.f_code.co_name)
        if r is not None and pkg in f.f_code.co_filename:
            return r
        f = f.f_back
    if name.startswith("device_poller"):
        return "poller"
    if name.startswith("client"):
        return "client"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generates", type=int, default=20,
                    help="Generates in the stack-sampled window")
    ap.add_argument("--blocks", type=int, default=65536,
                    help="blocks in each decode pool")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1
    from .. import policy  # noqa: F401  (registers tpu_std)
    from .. import rpc
    from ..butil import flags
    from ..examples.disagg_serving import model
    from ..examples.disagg_serving.workers import (
        BYTES_PER_TOKEN, close_services, start_decode_worker,
        start_prefill_worker, start_router)
    from ..ici.mesh import IciMesh
    from ..proto.echo_pb2 import EchoRequest, EchoResponse
    from ..serving import (BatchSchedulerOptions, ContinuousBatchScheduler,
                           KvPoolOptions, StepRequest)
    from .profile_echo import device_busy_share, sample_stacks
    from .timing import nvidia_smi_line

    print(nvidia_smi_line(), flush=True)
    mesh = IciMesh(ranks=8)
    IciMesh.set_default(mesh)
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    prefill = start_prefill_worker("ici://1", mesh=mesh)
    decodes = [start_decode_worker(f"ici://{r}", mesh=mesh,
                                   pool_options=KvPoolOptions(
                                       bytes_per_token=BYTES_PER_TOKEN,
                                       num_blocks=args.blocks,
                                       block_tokens=16))
               for r in (2, 3)]
    router = start_router("mem://profile-router", "ici://1",
                          ["ici://2", "ici://3"], rng=random.Random(8))
    rng = np.random.default_rng(9)
    chans = []

    def channel(target):
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(
            timeout_ms=120000, max_retry=0))
        chans.append(ch)
        return ch

    front = channel("mem://profile-router")

    def generate(tokens):
        cntl = rpc.Controller()
        front.call_method("Router.Generate", cntl, EchoRequest(
            message=json.dumps({"tokens": tokens, "steps": STEPS})),
            EchoResponse)
        if cntl.failed():
            raise RuntimeError(f"Generate failed: {cntl.error_text}")

    def generates(n: int, threads: int = 2) -> None:
        prompts = [rng.integers(0, model.VOCAB, PROMPT).tolist()
                   for _ in range(n)]

        def client(k):
            for i in range(k, n, threads):
                generate(prompts[i])

        ts = [threading.Thread(target=client, args=(k,), name=f"client{k}")
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)

    try:
        generates(4)                            # warm: build, streams
        out = {"prompt_tokens": PROMPT, "steps": STEPS,
               "generates": device_busy_share(lambda: generates(20),
                                             top=8)}
        # the full roster on decode rank 2
        dec = channel("ici://2")
        for i in range(ROSTER):
            tokens = rng.integers(0, model.VOCAB, PROMPT).tolist()
            kv = mesh.own(model.toy_kv_blocks(tokens, mesh.device(1)), 1)
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(kv)
            dec.call_method("Decode.LoadKv", cntl, EchoRequest(
                message=json.dumps({"session": f"p{i}", "seq_len": PROMPT,
                                    "last_token": tokens[-1]})),
                EchoResponse)
            if cntl.failed():
                raise RuntimeError(f"LoadKv failed: {cntl.error_text}")
        pool = next(iter(decodes[0].services().values())).pool
        sched = ContinuousBatchScheduler(pool, BatchSchedulerOptions(
            vocab=model.VOCAB, max_batch=ROSTER, auto_start=False))
        for i in range(ROSTER):
            sched.submit(StepRequest(f"p{i}", 10 ** 6, lambda t: None,
                                     lambda *a: None))
        sched.step_once()
        out["steps_at_roster_64"] = device_busy_share(
            lambda: [sched.step_once() for _ in range(STEPS)], top=8)
        sched.stop()
        for i in range(ROSTER):
            pool.release(f"p{i}")
        out["stacks"] = sample_stacks(lambda: generates(args.generates),
                                      role_of=role_of, top=32)
    finally:
        for ch in chans:
            ch.close()
        close_services(router, prefill, *decodes)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
