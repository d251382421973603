"""Parameter-server gradient push-pull with checkpoint and resume (the
rdma_performance "param-server" mode), ported from
``examples/param_server.py``.

A data-parallel trainer over the mesh: each rank computes a gradient
shard, a CollectiveChannel method merged as a sum (MAP_SHARD +
MERGE_SUM) pulls their total back, and the parameters are checkpointed
with ``torch.save`` (the JAX example's orbax) so training resumes exactly
where it stopped.

    python -m brpc_tpu_torch.examples.param_server            # card
    python -m brpc_tpu_torch.examples.param_server --device cpu
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch

from brpc_tpu_torch import channels
from brpc_tpu_torch.examples.common import parse_device, setup_mesh


def main(argv=None, steps: int = 6, resume_at: int = 3) -> int:
    mesh = setup_mesh(parse_device(argv, __doc__))
    n = mesh.size
    d = 32
    dev = mesh.device(0)
    cc = channels.CollectiveChannel(mesh)
    # the push-pull: every rank pushes its gradient shard, pulls the sum
    cc.register("ParamServer.PushPull", lambda g_shard: g_shard,
                merge=channels.MERGE_SUM, mapping=channels.MAP_SHARD)
    w = torch.zeros(d, dtype=torch.float32, device=dev)
    target = torch.linspace(0.0, 1.0, d, device=dev)

    def local_grads(w, step):
        """(n, d) gradient shards: a quadratic loss with per-rank
        minibatch noise."""
        g = 2 * (w - target)
        gen = torch.Generator(device="cpu").manual_seed(step)
        noise = torch.randn(n, d, generator=gen).to(dev) * 0.01
        return cc.shard(g[None, :] + noise)

    with tempfile.TemporaryDirectory(prefix="brpc_tpu_torch_ckpt_") as ckpt:
        losses = []
        step = 0
        while step < steps:
            if step == resume_at:
                # a restart: drop everything, restore from the checkpoint
                restored = torch.load(os.path.join(ckpt, f"step_{step}.pt"))
                w = restored["w"].to(dev)
                assert int(restored["step"]) == step
                print(f"resumed from checkpoint at step {step}")
            g_sum = cc.call("ParamServer.PushPull", local_grads(w, step))
            w = w - 0.05 * (g_sum / n)
            losses.append(float(((w - target) ** 2).sum()))
            step += 1
            if step == resume_at:
                torch.save({"w": w.cpu(), "step": step},
                           os.path.join(ckpt, f"step_{step}.pt"))
    print(f"losses: {[round(v, 4) for v in losses]}")
    assert losses[-1] < losses[0], "training must make progress"
    print(f"param-server push-pull over {n} ranks: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (checkpoint ok)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
